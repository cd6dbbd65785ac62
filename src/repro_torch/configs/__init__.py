"""Architecture registry of the port: one module per ported architecture.

Each arch module defines ``CONFIG`` (the exact configuration, a copy of the
reference's) and ``smoke_config()`` (a reduced same-family config for the CPU
tests). Only ``llama32_1b`` (dense) is ported; the other families of the
reference arrive with slice F and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ["llama32_1b"]


def _module(arch: str):
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (the port has {ARCH_IDS}; the "
            "other serving families arrive with slice F)")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
