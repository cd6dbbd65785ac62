"""Launcher of the pool-partial decode attention CUDA kernel
(``csrc/serving.cu``).

``pool_attention_partial_cuda`` replaces ``repro/kernels/tiered_attention/
kernel.py`` ``pool_attention_partial_tpu``. One thread block per (sequence,
kv head) holds the G = H/K query heads that share the kv head, so every K/V
row of the pool is read from device memory once, and walks the pool page by
page: free slots and pages outside the valid token range are skipped
without a load; scores, the online-softmax state and the per-page mass live
in shared memory; the mass of each page is kept with the running max it was
summed under and rescaled once to the final max, so the output is the plain
version's (mass relative to each head's final m; the TPU kernel's per-block
``mstab`` output is not carried over). Bound by device-memory bytes: about
one multiply-add per K/V element read.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import check_cuda, load_library, stream_of

MAX_HEAD_DIM = 128     # four values per lane of a warp


def pool_attention_partial_cuda(q, pool_k, pool_v, slot_page, seq_len, *,
                                window: Optional[int] = None,
                                sm_scale: Optional[float] = None):
    """q f32 [B,H,D]; pool_k/v bf16 or f32 [B,Mp,pt,K,D]; slot_page int32
    [B,Mp]; seq_len int32 [B]. Returns (acc [B,H,D], m [B,H], l [B,H],
    mass [B,H,Mp]), all f32."""
    check_cuda(q, torch.float32, 3, "q")
    if pool_k.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"pool: bf16 or f32, got {pool_k.dtype}")
    check_cuda(pool_k, pool_k.dtype, 5, "pool_k")
    check_cuda(pool_v, pool_k.dtype, 5, "pool_v")
    check_cuda(slot_page, torch.int32, 2, "slot_page")
    check_cuda(seq_len, torch.int32, 1, "seq_len")
    B, Mp, pt, K, D = pool_k.shape
    H = q.shape[1]
    if (pool_v.shape != pool_k.shape or q.shape != (B, H, D) or H % K
            or slot_page.shape != (B, Mp) or seq_len.shape != (B,)
            or not 1 <= D <= MAX_HEAD_DIM):
        raise ValueError(
            f"pool_attention_partial: bad shapes q {tuple(q.shape)} pool "
            f"{tuple(pool_k.shape)} slot_page {tuple(slot_page.shape)} "
            f"seq_len {tuple(seq_len.shape)} (head dim <= {MAX_HEAD_DIM})")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    acc = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    mass = torch.empty((B, H, Mp), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        load_library("serving").call(
            "pool_attention_partial_launch", q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), slot_page.data_ptr(), seq_len.data_ptr(),
            B, Mp, pt, K, H // K, D, int(window is not None),
            int(window or 0), ctypes.c_float(scale),
            int(pool_k.dtype == torch.bfloat16), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), mass.data_ptr(), stream_of(q))
    return acc, m, l, mass
