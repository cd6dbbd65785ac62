"""Launcher of the Mamba2 SSD chunked-scan CUDA kernel (``csrc/prefill.cu``).

``ssd_scan_cuda`` replaces ``repro/kernels/ssd_scan/kernel.py``
``ssd_scan_tpu``. One thread block per (batch, head) walks its chunks in
order with the state h [P, N] in float32 shared memory (the TPU kernel's
sequential chunk axis); inside a chunk it works on 64-row tiles, so the
Q x Q decay-weighted score block (256 KiB in float32 at Q = 256, more than
an SM holds) is never materialised whole, and B, C, X tiles are staged in
float32. x, a, b and c are read through their strides: B and C come per
group ([B,S,G,N], head h reads group h // (H/G)), so the caller neither
repeats groups to heads nor transposes. Bound by operations.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_strided, load_library, stream_of

MAX_P = 128
MAX_N = 128


def ssd_scan_cuda(x, a, b, c, chunk: int):
    """x [B,S,H,P] f32; a [B,S,H] f32; b, c [B,S,G,N] bf16 or f32 (the same
    dtype). Returns (y [B,S,H,P] f32, h [B,H,P,N] f32)."""
    check_strided(x, (torch.float32,), 4, "x")
    check_strided(a, (torch.float32,), 3, "a")
    check_strided(b, (torch.bfloat16, torch.float32), 4, "b")
    check_strided(c, (b.dtype,), 4, "c")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if (a.shape != (B, S, H) or b.shape != (B, S, G, N) or c.shape != b.shape
            or H % G or not 1 <= P <= MAX_P or not 1 <= N <= MAX_N
            or chunk < 1 or S % chunk):
        raise ValueError(
            f"ssd_scan: bad shapes x {tuple(x.shape)} a {tuple(a.shape)} b "
            f"{tuple(b.shape)} c {tuple(c.shape)} chunk {chunk} (G divides "
            f"H, P <= {MAX_P}, N <= {MAX_N}, S % chunk == 0)")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = [s for t in (x, a, b, c) for s in t.stride()[:3]]
    with torch.cuda.device(x.device):
        load_library("prefill").call(
            "ssd_scan_launch", x.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, H, G, P, N,
            chunk, *strides, int(b.dtype == torch.bfloat16), stream_of(x))
    return y, h
