"""Tiered paged KV cache — the Equilibria mechanism on the serving path
(torch port of the reference's ``memtier/kvcache.py``).

Layout (per decoder layer, stacked on a leading L axis):
  fast_k/v: [L, B, Mf, pt, K, D]   fast tier (device-memory pages)
  slow_k/v: [L, B, Ms, pt, K, D]   slow tier (CXL/host-class pages)

Pages are per-sequence; the *global* fast tier is a shared budget enforced by
the Equilibria policy (``memtier/tiering.py``). Page hotness is the per-page
attention mass emitted by the attention kernel: softmax weights are access
frequencies. Both pools are device buffers here; the latency difference of
a real slow tier is modeled, not measured.

The pools are updated in place (the token append here, the page moves in
``memtier/tiering.py``); the small metadata tensors are replaced, so a
step returns a new ``TieredKVCache`` that shares the pool tensors. The step
counter ``t`` is a host int.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TieringConfig
from repro_torch.core.state import (Counters, TenantPolicy, ThrashTable,
                                    zero_counters)
from repro_torch.device import resolve_device
from repro_torch.kernels.tiered_attention import ops as TA
from repro_torch.models.params import dtype_of
from repro_torch.obs.stats import TierStats, init_stats, record_fast_entries
from repro_torch.obs.trace import MigrationRing, init_ring


class TieredKVCache(NamedTuple):
    # pools (leading layer axis)
    fast_k: torch.Tensor      # [L, B, Mf, pt, K, D]
    fast_v: torch.Tensor
    slow_k: torch.Tensor      # [L, B, Ms, pt, K, D]
    slow_v: torch.Tensor
    # slot metadata [B, Mf] / [B, Ms]
    fast_page: torch.Tensor   # logical page id held by slot, -1 free (int32)
    slow_page: torch.Tensor
    fast_hot: torch.Tensor    # f32 EWMA attention mass
    slow_hot: torch.Tensor
    # logical page table [B, M]: tier (-1/0/1) and index within tier pool
    page_tier: torch.Tensor   # int8
    page_idx: torch.Tensor    # int32
    # sequence state
    seq_len: torch.Tensor     # [B] int32 tokens generated so far (position)
    tenant: torch.Tensor      # [B] int32
    # fairness state
    counters: Counters        # [T]
    promo_scale: torch.Tensor  # [T] f32
    thrash_prev: torch.Tensor  # [T] int32
    steady: torch.Tensor       # [T] bool
    mitigated_prev: torch.Tensor  # [T] bool: mitigation fired at last run
    table: ThrashTable
    # observability (obs/, §IV-C): fast_since is per fast *slot* [B, Mf]
    stats: TierStats
    ring: MigrationRing
    t: int                     # host-side step counter


def cache_dims(cfg: ModelConfig, shape_seq: int, page_tokens: int,
               fast_frac: float = 0.75, slack: float = 0.3):
    """Logical pages M and per-tier pool sizes (Mf, Ms) for a target context,
    all rounded up to multiples of 16 (the reference's rule)."""
    def r16(n):
        return max(16, ((n + 15) // 16) * 16)

    if cfg.sliding_window is not None:
        # ring over the window
        logical = r16(cfg.sliding_window // page_tokens + 2)
    else:
        logical = r16((shape_seq + page_tokens - 1) // page_tokens)
    mf = min(r16(int(np.ceil(logical * fast_frac)) + 1), logical)
    ms = min(r16(int(np.ceil(logical * slack)) + 1), logical)
    return logical, mf, ms


def kv_layer_count(cfg: ModelConfig) -> int:
    """Number of attention layers that need a paged KV cache: every layer
    of the dense and moe families and every decoder self-attention of the
    encdec (its cross K/V are not paged); none for the attention-free ssm
    family; for the hybrid, the reference's ``num_layers //
    hybrid_attn_every + 1`` (one per application of the shared block, plus
    one spare when ``every`` divides the depth); for the vlm, its self
    layers, ``num_layers - num_layers // cross_attn_every``."""
    if cfg.family in ("dense", "moe", "encdec"):
        return cfg.num_layers
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every + 1
    if cfg.family == "vlm":
        return cfg.num_layers - cfg.num_layers // cfg.cross_attn_every
    raise ValueError(f"unknown family {cfg.family!r}")


def init_cache(cfg: ModelConfig, tcfg: TieringConfig, batch: int, seq: int,
               device="cuda") -> TieredKVCache:
    """An empty cache for ``batch`` sequences of up to ``seq`` tokens;
    sequence b belongs to tenant b mod T."""
    dev = resolve_device(device)
    L = kv_layer_count(cfg)
    pt = tcfg.page_tokens
    M, Mf, Ms = cache_dims(cfg, seq, pt)
    K, D = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = dtype_of(cfg.dtype)
    T = tcfg.n_tenants

    def full(shape, fill, dtype=torch.int32):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    return TieredKVCache(
        fast_k=torch.zeros((L, batch, Mf, pt, K, D), dtype=dt, device=dev),
        fast_v=torch.zeros((L, batch, Mf, pt, K, D), dtype=dt, device=dev),
        slow_k=torch.zeros((L, batch, Ms, pt, K, D), dtype=dt, device=dev),
        slow_v=torch.zeros((L, batch, Ms, pt, K, D), dtype=dt, device=dev),
        fast_page=full((batch, Mf), -1), slow_page=full((batch, Ms), -1),
        fast_hot=full((batch, Mf), 0.0, torch.float32),
        slow_hot=full((batch, Ms), 0.0, torch.float32),
        page_tier=full((batch, M), -1, torch.int8),
        page_idx=full((batch, M), 0), seq_len=full((batch,), 0),
        tenant=torch.arange(batch, dtype=torch.int32, device=dev) % T,
        counters=zero_counters(T, dev),
        promo_scale=full((T,), 1.0, torch.float32),
        thrash_prev=full((T,), 0), steady=full((T,), False, torch.bool),
        mitigated_prev=full((T,), False, torch.bool),
        table=ThrashTable(page=full((tcfg.thrash_table_slots,), -1),
                          tick=full((tcfg.thrash_table_slots,), 0)),
        stats=init_stats(T, (batch, Mf), tcfg.obs_resid_buckets, dev),
        ring=init_ring(tcfg.obs_ring_capacity, dev),
        t=0)


# ------------------------------------------------------------ helpers ----
def by_tenant(x: torch.Tensor, tenant: torch.Tensor, n_tenants: int
              ) -> torch.Tensor:
    """Per-tenant int32 sum of a per-sequence count (the reference's
    ``one_hot(tenant).T @ x``): an integer scatter-add, order-free."""
    return torch.zeros((n_tenants,), dtype=torch.int32,
                       device=x.device).index_add_(
        0, tenant.to(torch.int64), x.to(torch.int32))


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none): the
    reference's ``argmax`` of a bool mask, through int32 (``torch.argmax``
    takes no bool)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _set_rows(x: torch.Tensor, cols: torch.Tensor, value: torch.Tensor
              ) -> torch.Tensor:
    """A copy of ``x`` [B, N] with ``x[b, cols[b]] = value[b]``."""
    out = x.clone()
    rows = torch.arange(x.shape[0], device=x.device)
    out[rows, cols.to(torch.int64)] = value.to(x.dtype)
    return out


def _rows(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``x[b, cols[b]]`` for every row b."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, cols.to(torch.int64)]


# ------------------------------------------------------- page allocation ----
def alloc_page_for_append(cache: TieredKVCache, tcfg: TieringConfig,
                          policy: TenantPolicy, fast_budget: int):
    """Allocate (or reuse, for SWA rings) the page that will hold this step's
    token, for every sequence. Fast placement requires the tenant to be under
    its upper bound AND the global fast budget to have headroom (§IV-D).
    Returns (cache, lpage [B])."""
    B, M = cache.page_tier.shape
    pt = cache.fast_k.shape[3]
    pos = cache.seq_len                                   # [B] write position
    apage = pos // pt                                     # absolute page id
    lpage = apage % M                                     # ring slot for SWA
    need_new = (pos % pt) == 0
    cur_tier = _rows(cache.page_tier, lpage).to(torch.int32)
    reuse = need_new & (cur_tier >= 0)                    # ring slot overwrite
    fresh = need_new & ~reuse

    # per-tenant fast accounting
    T = policy.lower_protection.shape[0]
    fast_cnt = (cache.fast_page >= 0).sum(dim=1, dtype=torch.int32)
    fast_usage = by_tenant(fast_cnt, cache.tenant, T)
    global_fast = fast_cnt.sum(dtype=torch.int32)
    ten = cache.tenant.to(torch.int64)
    bound = policy.upper_bound[ten]
    under_bound = (bound == 0) | (fast_usage[ten] < bound)
    fast_free_slot = cache.fast_page < 0                  # [B, Mf]
    has_fast_slot = fast_free_slot.any(dim=1)
    budget_rank = torch.cumsum(fresh.to(torch.int32), 0,
                               dtype=torch.int32) - 1
    budget_ok = (global_fast + budget_rank) < fast_budget
    go_fast = fresh & under_bound & has_fast_slot & budget_ok

    fast_slot = first_true(fast_free_slot)
    slow_slot = first_true(cache.slow_page < 0)

    # apply allocations
    new_tier = torch.where(go_fast, 0, 1).to(torch.int8)
    new_idx = torch.where(go_fast, fast_slot, slow_slot).to(torch.int32)
    page_tier = _set_rows(cache.page_tier, lpage, torch.where(
        fresh, new_tier, _rows(cache.page_tier, lpage)))
    page_idx = _set_rows(cache.page_idx, lpage, torch.where(
        fresh, new_idx, _rows(cache.page_idx, lpage)))
    take_fast = fresh & go_fast
    take_slow = fresh & ~go_fast
    fast_page = _set_rows(cache.fast_page, fast_slot, torch.where(
        take_fast, apage, _rows(cache.fast_page, fast_slot)))
    slow_page = _set_rows(cache.slow_page, slow_slot, torch.where(
        take_slow, apage, _rows(cache.slow_page, slow_slot)))
    # ring-slot reuse (SWA): refresh the pool slot's absolute page id. The
    # page's index is a slot of ONE pool; the reference's gather clamps it
    # into the other pool and its scatter drops it there, so clamping both
    # (a write-back of the unchanged value) is the same function.
    reuse_idx = _rows(cache.page_idx, lpage)
    fast_idx = torch.clamp(reuse_idx, 0, fast_page.shape[1] - 1)
    slow_idx = torch.clamp(reuse_idx, 0, slow_page.shape[1] - 1)
    fast_page = _set_rows(fast_page, fast_idx, torch.where(
        reuse & (cur_tier == 0), apage, _rows(fast_page, fast_idx)))
    slow_page = _set_rows(slow_page, slow_idx, torch.where(
        reuse & (cur_tier == 1), apage, _rows(slow_page, slow_idx)))
    alloc_t = by_tenant(fresh, cache.tenant, T)

    # obs: new fast-tier placements start their residency clock (§IV-C)
    entered = _set_rows(torch.zeros_like(cache.fast_page, dtype=torch.bool),
                        fast_slot, take_fast)
    stats = record_fast_entries(cache.stats, entered, cache.t)

    cache = cache._replace(
        page_tier=page_tier, page_idx=page_idx, fast_page=fast_page,
        slow_page=slow_page, stats=stats,
        counters=cache.counters._replace(
            allocations=cache.counters.allocations + alloc_t))
    return cache, lpage


# ------------------------------------------------------------- KV append ----
def append_token_kv(pool_k, pool_v, other_k, other_v, cache: TieredKVCache,
                    lpage, k_new, v_new) -> None:
    """Write this step's K/V ([B,1,K,D]) into the page allocated by
    ``alloc_page_for_append``, in place. ``pool_*`` are this layer's fast
    [B, Mf, pt, K, D] pools and ``other_*`` its slow ones; each sequence
    writes to the pool its page lives in."""
    B = k_new.shape[0]
    rows = torch.arange(B, device=k_new.device)
    tier = _rows(cache.page_tier, lpage)
    idx = _rows(cache.page_idx, lpage).to(torch.int64)
    off = (cache.seq_len % pool_k.shape[2]).to(torch.int64)
    kw, vw = k_new[:, 0], v_new[:, 0]
    is_fast = (tier == 0)[:, None, None]
    # masked writes into both pools (one is a no-op per sequence)
    fidx = torch.where(tier == 0, idx, 0)
    sidx = torch.where(tier == 0, 0, idx)
    pool_k[rows, fidx, off] = torch.where(is_fast, kw, pool_k[rows, fidx, off])
    pool_v[rows, fidx, off] = torch.where(is_fast, vw, pool_v[rows, fidx, off])
    other_k[rows, sidx, off] = torch.where(is_fast, other_k[rows, sidx, off],
                                           kw)
    other_v[rows, sidx, off] = torch.where(is_fast, other_v[rows, sidx, off],
                                           vw)


# ------------------------------------------------ tiered paged attention ----
def tiered_paged_attention(q, fast_k, fast_v, slow_k, slow_v, fast_page,
                           slow_page, seq_len, window: Optional[int] = None,
                           impl: str = "cuda"):
    """Decode attention over the two-tier paged cache: one pool-partial
    attention per tier (the K5 kernel through ``kernels/tiered_attention``,
    or its plain version for impl="ref"), merged.

    q: [B,1,H,D]; pools: [B,Mp,pt,K,D]; *_page: [B,Mp] absolute page ids;
    seq_len: [B] (this step's position, inclusive). Returns (out [B,1,H,D],
    fast_mass [B,Mf], slow_mass [B,Ms])."""
    return TA.tiered_attention(q, fast_k, fast_v, slow_k, slow_v, fast_page,
                               slow_page, seq_len, window=window, impl=impl)


def token_validity(cache: TieredKVCache, window: Optional[int]):
    """Valid token mask per pool slot: [B,Mf,pt], [B,Ms,pt]."""
    pt = cache.fast_k.shape[3]
    cur = cache.seq_len          # tokens 0..cur (cur inclusive: written)

    def valid(slot_page):
        base = slot_page.to(torch.int32) * pt                        # [B,Mp]
        tok = base[:, :, None] + torch.arange(pt, device=base.device)
        ok = (slot_page >= 0)[:, :, None] & (tok <= cur[:, None, None])
        if window is not None:
            ok &= tok > (cur[:, None, None] - window)
        return ok

    return valid(cache.fast_page), valid(cache.slow_page)


def kv_tier_counters(cache: TieredKVCache) -> dict:
    """Host-side snapshot of the serving-path tiering counters: {metric:
    [T] numpy int array} — the cgroup ``tier_stat`` analogue for the KV
    cache."""
    return {k: v.cpu().numpy() for k, v in cache.counters._asdict().items()}
