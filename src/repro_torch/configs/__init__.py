"""Architecture registry of the port: one module per ported architecture.

Each arch module defines ``CONFIG`` (the exact configuration, a copy of the
reference's), ``smoke_config()`` (a reduced same-family config for the CPU
tests) and ``SERVE_LOAD`` (sequences, decode steps of the serving load the
port is measured at). The dense (``llama32_1b``, ``codeqwen15_7b``,
``h2o_danube_3_4b``, ``qwen3_32b``), moe (``granite_moe_3b_a800m``,
``mixtral_8x22b``), ssm (``mamba2_130m``) and hybrid (``zamba2_7b``)
architectures are ported; the reference's encdec and vlm architectures
(``whisper_tiny``, ``llama32_vision_90b``) raise ``NotImplementedError``
here.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ["mixtral_8x22b", "granite_moe_3b_a800m", "qwen3_32b",
            "codeqwen15_7b", "h2o_danube_3_4b", "llama32_1b", "mamba2_130m",
            "zamba2_7b"]


def _module(arch: str):
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (the port has {ARCH_IDS}; the "
            "encdec and vlm families are still to port)")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_serve_load(arch: str) -> tuple:
    """(sequences, decode steps) of ``arch``'s measured serving load."""
    return _module(arch).SERVE_LOAD


def reduced_depth_config(arch: str, n: int) -> ModelConfig:
    """``arch``'s config at depth ``n``: the same widths, only the stacked
    layer count shrinks; the hybrid keeps a whole number of shared-block
    periods (the reference's rule, of which the encdec and vlm arms wait
    for their families)."""
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        n = max(cfg.hybrid_attn_every, (n // cfg.hybrid_attn_every)
                * cfg.hybrid_attn_every)
    return dataclasses.replace(cfg, num_layers=n)
