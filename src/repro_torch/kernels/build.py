"""Build and bind the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``; pointers come from
``tensor.data_ptr()`` and the stream from PyTorch's current stream. The
library is built at first use, keyed by a hash of the source and flags, into
``.kernel_build/`` at the root of the checkout (git-ignored). Nothing is
built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / ".kernel_build"
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the launchers in csrc/selection.cu
_SIGNATURES = {
    "seg_topk_launch": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    "seg_reduce_launch": (_P, _P, _I, _I, _P, _P, _P),
    "seg_sums_launch": (_P, _P, _I, _I, _P, _P),
    "commit_moves_launch": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _P),
}


class KernelLibrary:
    """A loaded kernel library: the ctypes handle plus its build record."""

    def __init__(self, lib: ctypes.CDLL, path: pathlib.Path,
                 build_s: float, log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s      # 0.0 when an existing build was reused
        self.log = log              # nvcc/ptxas output of the build

    def call(self, name: str, *args) -> None:
        """Call launcher ``name`` and raise on a non-zero CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            msg = self.lib.selection_error_string(err).decode()
            raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def _nvcc() -> str:
    # PyTorch's toolkit lookup: $CUDA_HOME, $CUDA_PATH, nvcc on PATH,
    # /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(nvcc)


@functools.cache
def load_library() -> KernelLibrary:
    """Compile ``csrc/selection.cu`` (once per source hash) and load it."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    src = CSRC / "selection.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}_{digest}.so"
    log_path = out.with_suffix(".log")
    build_s = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)           # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.selection_error_string.argtypes = [ctypes.c_int]
    lib.selection_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib, out, build_s, log)


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
