"""Build and bind the port's hand-written CUDA kernels.

Each source under ``csrc/`` (``selection.cu``: the tiering tick's selection
core; ``serving.cu``: the serving path's attention and page moves) is
compiled with ``nvcc`` into its own shared library with a plain C interface
and loaded with ``ctypes``; pointers come from ``tensor.data_ptr()`` and the
stream from PyTorch's current stream. A library is built at first use,
keyed by a hash of its source and the flags, into ``.kernel_build/`` at the
root of the checkout (git-ignored); ``build_all`` starts one ``nvcc`` per
missing library, all at once. Nothing is built or imported when this module
is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import time
from typing import Dict

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / ".kernel_build"
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C signatures of the launchers, by source
_SIGNATURES = {
    "selection": {
        "seg_topk_launch": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
        "seg_reduce_launch": (_P, _P, _I, _I, _P, _P, _P),
        "seg_sums_launch": (_P, _P, _I, _I, _P, _P),
        "commit_moves_launch": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _P),
    },
    "serving": {
        "pool_attention_partial_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _F, _I, _P, _P, _P,
                                          _P, _P),
        "migrate_pages_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P),
    },
}
SOURCES = tuple(_SIGNATURES)


class KernelLibrary:
    """A loaded kernel library: the ctypes handle plus its build record."""

    def __init__(self, name: str, lib: ctypes.CDLL, path: pathlib.Path,
                 build_s: float, log: str):
        self.name = name
        self.lib = lib
        self.path = path
        self.build_s = build_s      # 0.0 when an existing build was reused
        self.log = log              # nvcc/ptxas output of the build

    def call(self, name: str, *args) -> None:
        """Call launcher ``name`` and raise on a non-zero CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            msg = getattr(self.lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def _nvcc() -> str:
    # PyTorch's toolkit lookup: $CUDA_HOME, $CUDA_PATH, nvcc on PATH,
    # /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(nvcc)


def _artifact(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    """(source, library path) of kernel source ``name``."""
    if name not in _SIGNATURES:
        raise ValueError(f"unknown kernel source {name!r}; have {SOURCES}")
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}_{digest}.so"


_BUILD_S: Dict[str, float] = {}


def _compile(names) -> None:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process each, all running at once; raise if any fails."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    jobs = []
    for name in names:
        src, out = _artifact(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, src, out, tmp, proc, time.perf_counter()))
    errors = []
    for name, src, out, tmp, proc, t0 in jobs:
        stdout, stderr = proc.communicate()
        _BUILD_S[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)           # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.cache
def load_library(name: str = "selection") -> KernelLibrary:
    """Compile ``csrc/<name>.cu`` (once per source hash) and load it."""
    _compile([name])
    _, out = _artifact(name)
    lib = ctypes.CDLL(str(out))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    log_path = out.with_suffix(".log")
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(name, lib, out, _BUILD_S.get(name, 0.0), log)


def build_all() -> Dict[str, KernelLibrary]:
    """Build every kernel library in parallel, then load each."""
    _compile(SOURCES)
    return {name: load_library(name) for name in SOURCES}


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def check_cuda(x: torch.Tensor, dtype: torch.dtype, ndim: int,
               name: str) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype``/``ndim``."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
