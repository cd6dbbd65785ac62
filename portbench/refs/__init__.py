"""Plain float32 references of the benchmark's configurations, one module a
model family (``refs/<family>.py``), found by the family's name. They import
neither JAX nor the program: they take the weights and tokens the benchmark
drew from the seed and work out everything else again. Each family's module
also counts the work its model needs (``token_macs``, ``attention_calls``,
``scan_flops``, ``state_flops``), which ``portbench/work.py`` reads."""
import importlib


def of(family: str):
    """The reference module of model family ``family``."""
    return importlib.import_module(f"{__name__}.{family}")
