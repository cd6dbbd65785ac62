"""Launchers of the page-move CUDA kernels.

``migrate_pages_cuda`` (``csrc/serving.cu``) replaces
``repro/kernels/migrate/kernel.py`` ``migrate_pages_tpu``: for one pool
pair, or for two pairs that share the indices (K and V in one launch), a
fixed grid of two blocks per SM compacts the selected sequences in shared
memory and walks the work items (pool, layer, selected sequence, 16 KiB
chunk of the page) in a grid-stride loop; each thread issues its eight
16-byte loads of a chunk before its first store (byte copies when the page
size is not a multiple of 16 bytes or a pool is not 16-byte aligned). The
destination pools are updated in place, as the TPU kernel aliases them.
Bound by device-memory bytes: each selected page read once and written
once, no arithmetic.

``commit_moves_cuda`` (``csrc/selection.cu``) replaces
``repro/kernels/migrate/kernel.py`` ``commit_moves_tpu``: one cluster of
up to 16 thread blocks walks the compact [N = T·k] move stream once. Each
thread owns a run of consecutive lanes (16 at the tick's N = 16,384: one
16-byte load of ``take``), counts it with ``__popc`` and loads its lanes
with 16-byte loads; one exclusive scan of the run counts (in the block,
then over the blocks' totals through distributed shared memory) gives
every run its first ring offset and the total, and the thread then
commits the tier store and the packed ring row of each taken lane. Its
bound (the stream, the touched tier words and ring rows) is under a
launch's fixed cost, so latency (loads in flight, barriers) and the
scattered stores, spread over 16 SMs, are what the design cuts.
``tier`` and ``ring_data`` are updated in place, as the TPU kernel aliases
them; ``head`` stays on the device and the new head is written by the
kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import check_cuda, load_library, stream_of


def commit_moves_cuda(tier, ring_data, head, pages, take, tenants, hot_bits,
                      t: int, *, direction: int, to_tier: int):
    check_cuda(tier, torch.int32, 1, "tier")
    check_cuda(ring_data, torch.int32, 2, "ring_data")
    check_cuda(head, torch.int32, 0, "head")
    check_cuda(pages, torch.int32, 1, "pages")
    check_cuda(take, torch.bool, 1, "take")
    check_cuda(tenants, torch.int32, 1, "tenants")
    check_cuda(hot_bits, torch.int32, 1, "hot_bits")
    L = tier.shape[0]
    C = ring_data.shape[0]
    N = pages.shape[0]
    if ring_data.shape[1] != 5 or C < 1 or not (
            take.shape[0] == tenants.shape[0] == hot_bits.shape[0] == N):
        raise ValueError("commit_moves: bad shapes")
    head_out = torch.empty((), dtype=torch.int32, device=tier.device)
    with torch.cuda.device(tier.device):
        load_library().call(
            "commit_moves_launch", tier.data_ptr(), L, ring_data.data_ptr(),
            C, head.data_ptr(), head_out.data_ptr(), pages.data_ptr(),
            take.data_ptr(), tenants.data_ptr(), hot_bits.data_ptr(),
            N, int(t), int(direction), int(to_tier), stream_of(tier))
    return tier, ring_data, head_out


def migrate_pages_cuda(pairs, src_idx, dst_idx, sel):
    """pairs: one or two (src_pool, dst_pool) pairs, every pool
    [L, B, M, pt, K, D] of one dtype (M may differ between source and
    destination); src_idx/dst_idx int64 [B] and sel bool [B], shared by
    the pairs. Updates each ``dst_pool`` in place and returns them, in
    order."""
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"migrate_pages: 1 or 2 pool pairs, got {len(pairs)}")
    src0, dst0 = pairs[0]
    for k, (src, dst) in enumerate(pairs):
        check_cuda(src, src0.dtype, 6, f"src_pool[{k}]")
        check_cuda(dst, src0.dtype, 6, f"dst_pool[{k}]")
        if src.shape != src0.shape or dst.shape != dst0.shape:
            raise ValueError(f"migrate_pages: pair {k} has shapes "
                             f"{tuple(src.shape)} -> {tuple(dst.shape)}, "
                             f"pair 0 {tuple(src0.shape)} -> "
                             f"{tuple(dst0.shape)}")
    check_cuda(src_idx, torch.int64, 1, "src_idx")
    check_cuda(dst_idx, torch.int64, 1, "dst_idx")
    check_cuda(sel, torch.bool, 1, "sel")
    L, B, Ms = src0.shape[:3]
    Md = dst0.shape[2]
    if (dst0.shape[:2] != (L, B) or dst0.shape[3:] != src0.shape[3:]
            or not src_idx.shape == dst_idx.shape == sel.shape == (B,)):
        raise ValueError(f"migrate_pages: bad shapes src "
                         f"{tuple(src0.shape)} dst {tuple(dst0.shape)} idx "
                         f"{tuple(src_idx.shape)}")
    page_bytes = math.prod(src0.shape[3:]) * src0.element_size()
    src1, dst1 = pairs[-1]
    with torch.cuda.device(dst0.device):
        load_library("serving").call(
            "migrate_pages_launch", src0.data_ptr(), dst0.data_ptr(),
            src1.data_ptr(), dst1.data_ptr(), len(pairs), src_idx.data_ptr(),
            dst_idx.data_ptr(), sel.data_ptr(), L, B, Ms, Md,
            ctypes.c_longlong(page_bytes), stream_of(dst0))
    return tuple(dst for _, dst in pairs)
