"""Wrappers of the page-move kernels.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain version. ``migrate_pages`` updates the destination pool in place on
either (``migrate_pages_kv`` moves a K and a V pool pair that share the
indices, in one launch on the card); ``commit_moves`` updates ``tier``
and ``ring_data`` in place on the card, and its plain version returns new
tensors, so callers use the returned tensors. Launches are counted in
``<wrapper>.launches``; both page-move wrappers count their kernel's
launches in ``migrate_pages.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.migrate import kernel as K
from repro_torch.kernels.migrate import ref as R


def _indices(src_idx, dst_idx, sel):
    # int64 and bool, the tiering step's own dtypes: no cast kernel on its
    # path
    return (src_idx.to(torch.int64).contiguous(),
            dst_idx.to(torch.int64).contiguous(),
            sel.to(torch.bool).contiguous())


def migrate_pages(src_pool, dst_pool, src_idx, dst_idx, sel):
    """For every selected sequence b, copy page ``src_idx[b]`` of
    ``src_pool`` into slot ``dst_idx[b]`` of ``dst_pool`` in every layer,
    in place. Pools [L, B, Mp, pt, K, D]; src_idx/dst_idx/sel [B]. Returns
    ``dst_pool``."""
    idx = _indices(src_idx, dst_idx, sel)
    if dst_pool.is_cuda:
        migrate_pages.launches += 1
        return K.migrate_pages_cuda(((src_pool, dst_pool),), *idx)[0]
    return R.migrate_pages_ref(src_pool, dst_pool, *idx)


def migrate_pages_kv(src_k, dst_k, src_v, dst_v, src_idx, dst_idx, sel):
    """``migrate_pages`` of the K pools and of the V pools with the same
    indices: one kernel launch on the card. Returns (dst_k, dst_v)."""
    idx = _indices(src_idx, dst_idx, sel)
    if dst_k.is_cuda:
        migrate_pages.launches += 1
        return K.migrate_pages_cuda(((src_k, dst_k), (src_v, dst_v)), *idx)
    return R.migrate_pages_kv_ref(src_k, dst_k, src_v, dst_v, *idx)


def commit_moves(tier, ring_data, head, pages, take, tenants, hot, t: int, *,
                 direction: int, to_tier: int):
    """Fused tier scatter + migration-ring append over a compact move
    stream. tier [L] int32; ring_data [C, 5] int32; head 0-d int32;
    pages [N] int32 (sentinel L on non-taken lanes is fine); take [N] bool;
    tenants [N] int32; hot [N] f32 (hotness-at-move, ring-bitcast); t the
    tick. Returns (tier', ring_data', head')."""
    hot_bits = hot.to(torch.float32).contiguous().view(torch.int32)
    pages = pages.to(torch.int32).contiguous()
    take = take.to(torch.bool).contiguous()
    tenants = tenants.to(torch.int32).contiguous()
    if tier.is_cuda:
        commit_moves.launches += 1
        return K.commit_moves_cuda(tier, ring_data, head, pages, take,
                                   tenants, hot_bits, t, direction=direction,
                                   to_tier=to_tier)
    return R.commit_moves_ref(tier, ring_data, head, pages, take, tenants,
                              hot_bits, t, direction=direction,
                              to_tier=to_tier)


migrate_pages.launches = 0
commit_moves.launches = 0
