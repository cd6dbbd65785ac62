"""Wrapper of the fused page-move commit kernel.

A CUDA tensor goes to the hand-written kernel (in place on ``tier`` and
``ring_data``); a CPU tensor goes to the plain version (which returns new
tensors). Callers use the returned tensors either way. Launches are counted
in ``commit_moves.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.migrate import kernel as K
from repro_torch.kernels.migrate import ref as R


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


commit_moves.launches = 0
