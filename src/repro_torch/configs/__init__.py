"""Architecture registry of the port: one module per ported architecture.

Each arch module defines ``CONFIG`` (the exact configuration, a copy of the
reference's), ``smoke_config()`` (a reduced same-family config for the CPU
tests) and ``SERVE_LOAD`` (sequences, decode steps of the serving load the
port is measured at). All ten of the reference's architectures are
ported: dense (``llama32_1b``, ``codeqwen15_7b``, ``h2o_danube_3_4b``,
``qwen3_32b``), moe (``granite_moe_3b_a800m``, ``mixtral_8x22b``), ssm
(``mamba2_130m``), hybrid (``zamba2_7b``), encdec (``whisper_tiny``) and
vlm (``llama32_vision_90b``).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import SHAPES, ModelConfig

ARCH_IDS = ["mixtral_8x22b", "granite_moe_3b_a800m", "qwen3_32b",
            "codeqwen15_7b", "h2o_danube_3_4b", "llama32_1b", "mamba2_130m",
            "whisper_tiny", "llama32_vision_90b", "zamba2_7b"]


def _module(arch: str):
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r} (the port has {ARCH_IDS})")
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
    layer counts shrink (the reference's rule): the vlm keeps a whole
    number of (``cross_attn_every`` - 1 self + 1 cross) units, the encdec
    cuts its encoder to ``n`` too, and the hybrid keeps a whole number of
    shared-block periods."""
    cfg = get_config(arch)
    if cfg.family == "vlm":
        n = max(cfg.cross_attn_every, (n // cfg.cross_attn_every)
                * cfg.cross_attn_every)
        return dataclasses.replace(cfg, num_layers=n)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=n, encoder_layers=n)
    if cfg.family == "hybrid":
        n = max(cfg.hybrid_attn_every, (n // cfg.hybrid_attn_every)
                * cfg.hybrid_attn_every)
    return dataclasses.replace(cfg, num_layers=n)


def shape_cells(arch: str):
    """The assigned (shape) cells for one arch, with principled skips."""
    cfg = get_config(arch)
    cells = []
    for name, sh in SHAPES.items():
        if name == "long_500k" and not cfg.has_subquadratic_path:
            continue  # pure full-attention archs skip long-context decode
        cells.append(sh)
    return cells
