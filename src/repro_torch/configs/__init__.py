"""Architecture registry of the port: one module per ported architecture.

Each arch module defines ``CONFIG`` (the exact configuration, a copy of the
reference's), ``smoke_config()`` (a reduced same-family config for the CPU
tests) and ``SERVE_LOAD`` (sequences, decode steps of the serving load the
port is measured at). ``llama32_1b`` (dense) and ``zamba2_7b`` (hybrid) are ported; the
reference's other architectures (the moe, encdec, vlm and ssm families)
raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ["llama32_1b", "zamba2_7b"]


def _module(arch: str):
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (the port has {ARCH_IDS}; the "
            "moe, encdec, vlm and ssm families are still to port)")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_serve_load(arch: str) -> tuple:
    """(sequences, decode steps) of ``arch``'s measured serving load."""
    return _module(arch).SERVE_LOAD
