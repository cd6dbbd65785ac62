"""Hotness providers: how the tick learns which pages are hot (torch port of
``repro/core/hotness.py``; the ``exact`` provider only).

Hotness is a seam of ``core.tick.make_tick_core``: a provider owns an
optional state plus the update/candidate ops tick steps 3-6b consume. The
exact provider recomputes the dense [L] EWMA every tick. The sampled, sketch
and neomem providers arrive in a later slice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core import select as SEL
from repro_torch.core.state import TIER_SLOW
from repro_torch.device import resolve_device
from repro_torch.numerics import fused_mul_add

def cold_score(t: int, last_access: torch.Tensor,
               hot: torch.Tensor) -> torch.Tensor:
    """The ONE demotion/reclaim ranking score: LRU age in ticks, hotness as
    the tiebreak within an age class (higher = colder = demoted first)."""
    return (t - last_access).to(torch.float32) * 1e3 - hot


# ------------------------------------------------------------- the seam ----
class RowSpace(NamedTuple):
    """Tenant-local page addressing: row t lists tenant t's pages."""
    page: torch.Tensor    # [T, S] int32 page id, -1 = empty slot
    valid: torch.Tensor   # [T, S] bool


class HotCtx(NamedTuple):
    """Everything tick step 3 hands the active hotness provider."""
    hstate: Any                    # provider state (None = stateless)
    prev_hot: torch.Tensor         # [L] post-lifecycle hot from last tick
    accesses: torch.Tensor         # [L] f32 this tick
    alive: torch.Tensor            # [L] bool
    new: torch.Tensor              # [L] bool pages allocated this tick
    tier: torch.Tensor             # [L] int32, post-allocation
    last_access: torch.Tensor      # [L] int32, post-recency-update
    owner: torch.Tensor            # [L] int32
    owner_c: torch.Tensor          # [L] int32 gather-safe owner
    t: int                         # the tick
    rows: Callable[[], RowSpace]   # lazy tenant rowspace
    strategy: SEL.Strategy         # the ownership provider's selection ops


class PromoCand(NamedTuple):
    """Promotion-candidate ops for tick step 6 (post-demotion tier view)."""
    cand_t: torch.Tensor                                 # [T] candidate count
    select: Callable[[torch.Tensor], SEL.Selection]      # quotas [T]
    select_global: Callable[[torch.Tensor], SEL.Selection]  # budget (tpp)


class HotnessView(NamedTuple):
    """One tick's hotness products, consumed by tick steps 3-6b."""
    hstate: Any                    # carried into the next TierState
    hot: torch.Tensor              # [L] dense hotness
    demand_t: torch.Tensor         # [T] promotion demand (step 4, pre-cap)
    promo_cand: Callable[[torch.Tensor, torch.Tensor], PromoCand]
    demote: Callable[[torch.Tensor, torch.Tensor], SEL.Selection]
    demote_global: Callable[[torch.Tensor, torch.Tensor], SEL.Selection]


class HotnessProvider(NamedTuple):
    name: str
    init: Callable[[], Any]        # build the state (None = stateless)
    step: Callable[[HotCtx], HotnessView]


def _dense_view(cfg: TieringConfig, k_max: int, ctx: HotCtx,
                hot: torch.Tensor, hstate: Any) -> HotnessView:
    """The exact engine's candidate/selection ops over a dense hot vector."""
    T = cfg.n_tenants
    thr = cfg.promo_hot_threshold
    strat = ctx.strategy
    cand_pre = (ctx.tier == TIER_SLOW) & (hot >= thr) & ctx.alive
    demand_t = strat.by_tenant(cand_pre.to(torch.int32), ctx.owner)
    cold = cold_score(ctx.t, ctx.last_access, hot)

    def demote(fast_mask, quotas):
        return strat.select(cold, ctx.owner, fast_mask, quotas)

    def demote_global(fast_mask, quota):
        return SEL.Selection(
            SEL.select_global(cold, fast_mask, quota, k_max * T),
            None, None, None)

    def promo_cand(tier, demoted):
        cand = (tier == TIER_SLOW) & (hot >= thr) & ctx.alive & ~demoted
        cand_t = strat.by_tenant(cand.to(torch.int32), ctx.owner)
        return PromoCand(
            cand_t,
            lambda quotas: strat.select(hot, ctx.owner, cand, quotas),
            lambda quota: SEL.Selection(
                SEL.select_global(hot, cand, quota, k_max * T),
                None, None, None))

    return HotnessView(hstate=hstate, hot=hot, demand_t=demand_t,
                       promo_cand=promo_cand, demote=demote,
                       demote_global=demote_global)


def exact_hotness(cfg: TieringConfig, n_pages: int,
                  k_max: int) -> HotnessProvider:
    """The dense EWMA ``where(alive, decay * prev + accesses, 0)``, with the
    reference's single rounding of the multiply-add."""
    def step(ctx: HotCtx) -> HotnessView:
        hot = torch.where(ctx.alive,
                          fused_mul_add(cfg.hot_decay, ctx.prev_hot,
                                        ctx.accesses), 0.0)
        return _dense_view(cfg, k_max, ctx, hot, None)

    return HotnessProvider("exact", lambda: None, step)


def resolve_hotness(spec, cfg: TieringConfig, n_pages: int,
                    k_max: int) -> HotnessProvider:
    """Accepts None/"exact" (the dense EWMA) or a prebuilt HotnessProvider."""
    if spec is None or spec == "exact":
        return exact_hotness(cfg, n_pages, k_max)
    if isinstance(spec, HotnessProvider):
        return spec
    raise NotImplementedError(
        f"hotness provider {spec!r}: only 'exact' is ported so far")


def static_rowspace(owner: np.ndarray, n_tenants: int,
                    device="cuda") -> RowSpace:
    """RowSpace for a constant owner vector (any permutation)."""
    device = resolve_device(device)
    owner = np.asarray(owner)
    counts = np.bincount(owner, minlength=n_tenants)[:n_tenants]
    S = max(int(counts.max()) if counts.size else 1, 1)
    page = np.full((n_tenants, S), -1, np.int32)
    for ti in range(n_tenants):          # host-side, once per build
        ids = np.nonzero(owner == ti)[0]
        page[ti, :ids.size] = ids
    page_t = torch.as_tensor(page, device=device)
    return RowSpace(page=page_t, valid=page_t >= 0)
