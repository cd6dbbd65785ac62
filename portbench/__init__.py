"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything that belongs to one configuration, traffic mix or
per-layer metric sits in a file of its own (``configs/``, ``workloads/``,
``metrics/``), found by the name ``BENCHMARK.json`` gives it.
"""
import os
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]


def configure_environment() -> None:
    """Set, before torch is imported, what the program and torch read from
    the environment: every build and kernel cache at a fixed path inside the
    checkout, and no JAX behind ``transformers``."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
