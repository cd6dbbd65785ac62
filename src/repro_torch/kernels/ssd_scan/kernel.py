"""Launcher of the Mamba2 SSD chunked-scan CUDA kernels (``csrc/prefill.cu``).

``ssd_scan_cuda`` replaces ``repro/kernels/ssd_scan/kernel.py``
``ssd_scan_tpu``. The TPU kernel walks the chunks of each (batch, head) in
order, carrying the state h [P, N]; here the scan is split as the plain
version splits it (Mamba2's chunk-parallel form), into three device
launches behind one call:

1. chunk states, a block per (batch, head, chunk): the chunk's a_cum in
   float64 (its last entry is the chunk's total decay A_c) and its state
   s_c = (B o exp(a_cum_last - a_cum))^T X, written to scratch ([B,H,S]
   f64, [B,H,nc,N,P] f32);
2. state pass, a thread per (batch, head, n, p), sequential over chunks:
   h_in[c] = h, h = exp(A_c) h + s_c (h_in overwrites s_c), then the final
   h;
3. chunk outputs, a block per (batch, head, chunk, 64-row tile, 64 columns
   of P), heaviest tiles first: y_i = exp(a_cum_i) (C_i h_in^T) +
   sum_{j <= i} ((C_i B_j^T) o L_ij) X_j, written once.

a_cum and a_cum_i - a_cum_j stay in float64 and are rounded once before
exp; L is selected to 0 above the diagonal. B, C and X tiles are staged in
shared memory with 16-byte ``cp.async``, double-buffered; the products are
register-tiled float32 on the CUDA cores (4 x 4 outputs a thread). Bound
by operations: about Q^2 (N + P) + 4 Q P N flops per chunk and head. x, a,
b and c are read through their strides; B and C come per group
([B,S,G,N], head h reads group h // (H/G)), so the caller neither repeats
groups nor transposes. The scratch holds N P S/Q floats and S doubles
per (batch, head): 264 MB at S=32,768 on Zamba2-7B's widths.
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
    nc = S // chunk
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    states = torch.empty((B, H, nc, N, P), dtype=torch.float32, device=dev)
    acum = torch.empty((B, H, S), dtype=torch.float64, device=dev)
    strides = [s for t in (x, a, b, c) for s in t.stride()[:3]]
    with torch.cuda.device(dev):
        load_library("prefill").call(
            "ssd_scan_launch", x.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), h.data_ptr(), states.data_ptr(),
            acum.data_ptr(), B, S, H, G, P, N, chunk, *strides,
            int(b.dtype == torch.bfloat16), stream_of(x))
    return y, h
