"""Launcher of the pool-partial decode attention CUDA kernels
(``csrc/serving.cu``).

``pool_attention_partial_cuda`` replaces ``repro/kernels/tiered_attention/
kernel.py`` ``pool_attention_partial_tpu``. A flash-decode split: block
(sequence, kv head, head group, split) holds up to four of the G = H/K
query heads that share the kv head (each K/V row is read once for all of
them; G = 1, 2 and 4 are one group) and walks a contiguous range of pool
slots; a second small kernel merges the splits' (acc, m, l) and rescales
each page's mass to its head's final m. With one split the first kernel
writes the result itself and the merge is not launched: one or two device
launches per call.

The number of splits (``num_splits``): enough blocks that about two per
SM are in flight (2 x 132 on an H100), but no split shorter than one page
per warp (4 slots), and at most 32. On the serving paths B x K is 512
(Llama 3.2 1B, 64 sequences) and 1,024 (Zamba2-7B, 32 sequences), so they
run one split; small batches split.

Bound by device-memory bytes: about one multiply-add per K/V element read.
Inside a block the valid slots of the range are listed first (free slots
and pages outside the window drop out before any load); then each of the
block's four warps walks its own pages in units of up to 16 tokens, with
its own online softmax and a private two-stage ring of 16-byte
``cp.async`` copies (the next units load while one is computed), so the
loop has no block barrier. A lane holds four rows' 16-byte chunks and its
query chunks in registers: a reduce-scatter over a row's 8 lanes leaves
each lane one head's score, the lane runs that head's softmax and page
mass over the warp's four row groups, and P V accumulates in registers.
The warps' partials merge once at the end. The split kernel is a
programmatic dependent launch, so the second tier's call has its blocks
resident when the first ends.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import check_cuda, load_library, stream_of

MAX_HEAD_DIM = 128     # four 16-byte chunks per lane of an 8-lane row
WARPS = 4              # warps of a block, each walking its own pages
UNIT = 16              # token rows of a warp's unit
MAX_SPLITS = 32        # the merge holds one split per lane
BLOCKS_PER_SM = 2      # blocks in flight that the split count aims at


def num_splits(B: int, K: int, Mp: int, sms: int = 132) -> tuple[int, int]:
    """(splits, slots per split) for B sequences x K kv heads over Mp slots
    on a card of ``sms`` SMs."""
    want = -(-BLOCKS_PER_SM * sms // max(1, B * K))
    n = max(1, min(want, Mp // WARPS, MAX_SPLITS))
    per = -(-Mp // n)
    return -(-Mp // per), per


def pool_attention_partial_cuda(q, pool_k, pool_v, slot_page, seq_len, *,
                                window: Optional[int] = None,
                                sm_scale: Optional[float] = None):
    """q bf16 or f32 [B,H,D]; pool_k/v bf16 or f32 [B,Mp,pt,K,D];
    slot_page int32 [B,Mp]; seq_len int32 [B]. Returns (acc [B,H,D],
    m [B,H], l [B,H], mass [B,H,Mp]), all f32 (scores in float32 from
    either input type)."""
    for name, t in (("q", q), ("pool", pool_k)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name}: bf16 or f32, got {t.dtype}")
    check_cuda(q, q.dtype, 3, "q")
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
    G = H // K
    dev = q.device
    n, per = num_splits(B, K, Mp, torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    acc = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    mass = torch.empty((B, H, Mp), dtype=torch.float32, device=dev)
    if n > 1:
        parts = (torch.empty((n, B, H, D), dtype=torch.float32, device=dev),
                 torch.empty((n, B, H), dtype=torch.float32, device=dev),
                 torch.empty((n, B, H), dtype=torch.float32, device=dev))
    else:
        parts = (acc, m, l)
    with torch.cuda.device(dev):
        load_library("serving").call(
            "pool_attention_partial_launch", q.data_ptr(),
            int(q.dtype == torch.bfloat16), pool_k.data_ptr(),
            pool_v.data_ptr(), slot_page.data_ptr(), seq_len.data_ptr(),
            B, Mp, pt, K, G, D, int(window is not None),
            int(window or 0), ctypes.c_float(scale),
            int(pool_k.dtype == torch.bfloat16), n, per,
            *(t.data_ptr() for t in parts), acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), mass.data_ptr(), stream_of(q))
    return acc, m, l, mass
