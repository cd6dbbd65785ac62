"""Launchers of the page-move CUDA kernels.

``migrate_pages_cuda`` (``csrc/serving.cu``) replaces
``repro/kernels/migrate/kernel.py`` ``migrate_pages_tpu``: one thread block
per (layer, sequence) copies one whole [pt, K, D] page of a selected
sequence with 16-byte vector loads and stores (byte copies when the page
size is not a multiple of 16 bytes) and returns at once for an unselected
one; the destination pool is updated in place, as the TPU kernel aliases
it. Bound by device-memory bytes: two bytes moved per byte copied, no
arithmetic.

``commit_moves_cuda`` (``csrc/selection.cu``) replaces
``repro/kernels/migrate/kernel.py`` ``commit_moves_tpu``: one thread block
walks the compact [N = T·k] move stream twice — a count of the taken lanes,
then a chunked exclusive scan that hands each taken lane its ring offset —
and commits the tier store and the packed ring row in the same pass. Bound
by device-memory bytes (the stream, the touched tier words and ring rows);
a single block suffices because N is a few tens of thousands of lanes.
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


def migrate_pages_cuda(src_pool, dst_pool, src_idx, dst_idx, sel):
    """src/dst_pool [L, B, Mp, pt, K, D] of one dtype; src_idx/dst_idx/sel
    int32 [B]. Updates ``dst_pool`` in place and returns it."""
    check_cuda(src_pool, src_pool.dtype, 6, "src_pool")
    check_cuda(dst_pool, src_pool.dtype, 6, "dst_pool")
    for name, x in (("src_idx", src_idx), ("dst_idx", dst_idx), ("sel", sel)):
        check_cuda(x, torch.int32, 1, name)
    L, B, Ms = src_pool.shape[:3]
    Md = dst_pool.shape[2]
    if (dst_pool.shape[:2] != (L, B)
            or dst_pool.shape[3:] != src_pool.shape[3:]
            or not src_idx.shape == dst_idx.shape == sel.shape == (B,)):
        raise ValueError(f"migrate_pages: bad shapes src "
                         f"{tuple(src_pool.shape)} dst "
                         f"{tuple(dst_pool.shape)} idx {tuple(src_idx.shape)}")
    page_bytes = math.prod(src_pool.shape[3:]) * src_pool.element_size()
    with torch.cuda.device(dst_pool.device):
        load_library("serving").call(
            "migrate_pages_launch", src_pool.data_ptr(), dst_pool.data_ptr(),
            src_idx.data_ptr(), dst_idx.data_ptr(), sel.data_ptr(), L, B, Ms,
            Md, ctypes.c_longlong(page_bytes), stream_of(dst_pool))
    return dst_pool
