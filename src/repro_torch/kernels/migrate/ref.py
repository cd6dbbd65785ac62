"""Plain torch versions of the page-move kernels (one to one with
``repro/kernels/migrate/ref.py``): the KV-pool page copy of the serving
path and the tick's fused page-move commit."""
from __future__ import annotations

import torch


def migrate_pages_ref(src_pool, dst_pool, src_idx, dst_idx, sel):
    """src/dst_pool: [L, B, Mp, pt, K, D]; src_idx/dst_idx/sel: [B].
    Writes page ``src_pool[:, b, src_idx[b]]`` at ``dst_idx[b]`` of
    ``dst_pool`` for every selected b, in place, and returns ``dst_pool``.
    Indices are clamped into the pools, as the kernels clamp them."""
    B = src_pool.shape[1]
    b = torch.arange(B, device=src_pool.device)
    si = torch.clamp(src_idx.to(torch.int64), 0, src_pool.shape[2] - 1)
    di = torch.clamp(dst_idx.to(torch.int64), 0, dst_pool.shape[2] - 1)
    keep = (sel != 0)[None, :, None, None, None]
    dst_pool[:, b, di] = torch.where(keep, src_pool[:, b, si],
                                     dst_pool[:, b, di])
    return dst_pool


def commit_moves_ref(tier, ring_data, head, pages, take, tenants, hot_bits,
                     t: int, *, direction: int, to_tier: int):
    """tier [L] int32; ring_data [C, 5] int32; head 0-d int32; pages/tenants/
    hot_bits [N] int32 (hot scores pre-bitcast); take [N] bool. Returns new
    (tier', ring_data', head'): taken lanes set ``tier[page] = to_tier`` and
    append ``(t, tenant, page, direction, hot_bits)`` at ring slot
    ``(head + rank among taken) mod C``, keeping only the newest C."""
    L = tier.shape[0]
    C = ring_data.shape[0]
    N = take.shape[0]
    m = take.to(torch.bool)
    offs = torch.cumsum(m.to(torch.int32), 0, dtype=torch.int32) - 1
    total = offs[-1] + 1
    keep = m & (offs >= total - C)             # newest C events win
    idx = torch.where(keep, (head + offs) % C, C)   # C = dump row
    dev = tier.device
    rows = torch.stack([
        torch.full((N,), t, dtype=torch.int32, device=dev),
        tenants.to(torch.int32),
        pages.to(torch.int32),
        torch.full((N,), direction, dtype=torch.int32, device=dev),
        hot_bits.to(torch.int32),
    ], dim=-1)
    data = torch.cat([ring_data, ring_data.new_zeros((1, 5))])
    data.index_copy_(0, idx.to(torch.int64), rows)
    dest = torch.where(m & (pages >= 0) & (pages < L), pages, L)
    tier2 = torch.cat([tier, tier.new_zeros(1)])
    tier2.index_fill_(0, dest.to(torch.int64), to_tier)
    return tier2[:L], data[:C], head + m.sum(dtype=torch.int32)
