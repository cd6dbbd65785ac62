"""The unified tick core (torch port of ``repro/core/tick.py``, static
ownership).

ONE regulated promotion/demotion pipeline (hotness -> Eq.1 demotion scan ->
Eq.2 promotion scan -> upper-bound sync demotion -> thrash mitigation ->
§IV-C telemetry), parameterized by an **ownership provider**. This slice
ports the static provider: the owner vector is a constant, per-tick inputs
are ``(accesses [L] f32, alive [L] bool)`` and the lifecycle step frees
pages whose tenant trace died.

The tick is a plain function on tensors; ``core/engine.py`` drives it with a
Python loop. The tick counter ``state.t`` is a host int, so the periodic
controller is a plain ``if``. The reference skips two blocks with a
data-dependent ``lax.cond`` (the death-exit scatter and the allocation
block); both are value no-ops on their false branch, so they run
unconditionally here and the tick never waits on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core import hotness as HOT
from repro_torch.core import policy as P
from repro_torch.core import select as SEL
from repro_torch.core.state import (TIER_FAST, TIER_NONE, TIER_SLOW,
                                    Counters, TenantPolicy, ThrashTable,
                                    TierState, make_policy)
from repro_torch.device import resolve_device
from repro_torch.numerics import f32
from repro_torch.obs import stats as OS
from repro_torch.obs import trace as OT

MODES = ("equilibria", "tpp", "memtis", "static")


class TickOutput(NamedTuple):
    fast_usage: torch.Tensor      # [T] pages
    slow_usage: torch.Tensor      # [T]
    promotions: torch.Tensor      # [T] this tick
    demotions: torch.Tensor       # [T]
    throughput: torch.Tensor      # [T] accesses per latency-unit (1.0 = all-fast)
    latency: torch.Tensor         # [T] mean access latency (units of lat_fast)
    promo_scale: torch.Tensor     # [T]
    thrash_events: torch.Tensor   # [T] cumulative
    fast_free: torch.Tensor       # 0-d
    attempted_promotions: torch.Tensor  # [T] candidates this tick (obs)
    pool_free: torch.Tensor       # 0-d: unallocated pages


class Prepared(NamedTuple):
    """Everything tick step 1 (the ownership/lifecycle step) hands to the
    shared pipeline; controller fields are this tick's carry-ins."""
    owner: torch.Tensor          # [L] effective owner this tick
    owner_c: torch.Tensor        # [L] gather-safe owner
    alive: torch.Tensor          # [L] bool
    active: torch.Tensor         # [T] bool tenant roster this tick
    accesses: torch.Tensor       # [L] f32
    tier: torch.Tensor           # [L] int32, post-lifecycle
    hot: torch.Tensor            # [L] f32, post-lifecycle
    table: ThrashTable
    stats: OS.TierStats
    ring: OT.MigrationRing
    pol: TenantPolicy
    freed_t: torch.Tensor        # [T] pages freed by the lifecycle step
    rows: Callable[[], HOT.RowSpace]  # lazy tenant-local page rowspace
    promo_scale: torch.Tensor    # [T] controller carry-ins --------------
    steady: torch.Tensor
    mitigated_prev: torch.Tensor
    thrash_prev: torch.Tensor
    usage_prev: torch.Tensor
    freed_since: torch.Tensor


class OwnershipProvider(NamedTuple):
    """The seam between a deployment shape and the shared tick pipeline."""
    n_pages: int
    strategy: SEL.Strategy
    prepare: Callable[[TierState, tuple], Prepared]
    pool_free: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def static_ownership(cfg: TieringConfig, owner: np.ndarray, k_max: int,
                     impl: str = "batched", device="cuda"
                     ) -> OwnershipProvider:
    """Fixed tenant roster: ``owner`` [L] is a constant, per-tick inputs are
    ``(accesses [L] f32, alive [L] bool)`` from a prebuilt trace. The
    lifecycle step only frees pages whose trace liveness ended."""
    device = resolve_device(device)
    T = cfg.n_tenants
    owner_j = torch.as_tensor(np.asarray(owner, np.int32), device=device)
    strategy = SEL.static_strategy(owner, T, k_max, impl=impl, device=device)
    pol = make_policy(cfg, device)
    rs_cache: list = []   # the rowspace is a constant; build once, on demand

    def rows() -> HOT.RowSpace:
        if not rs_cache:
            rs_cache.append(HOT.static_rowspace(np.asarray(owner), T, device))
        return rs_cache[0]

    def prepare(state: TierState, inputs) -> Prepared:
        accesses, alive = inputs
        t = state.t
        tier = state.tier.to(torch.int32)        # a fresh tensor every tick
        died = (tier != TIER_NONE) & ~alive
        freed_t = strategy.by_tenant(died.to(torch.int32), owner_j)
        # fast-resident pages that die end their residency here (obs); an
        # empty mask is a value no-op, so this runs on every tick
        stats = OS.record_fast_exits(state.stats, died & (tier == TIER_FAST),
                                     owner_j, t)
        tier = torch.where(died, TIER_NONE, tier)
        active = strategy.by_tenant(alive.to(torch.int32), owner_j) > 0
        return Prepared(
            owner=state.owner, owner_c=owner_j, alive=alive, active=active,
            accesses=accesses, tier=tier, hot=state.hot, table=state.table,
            stats=stats, ring=state.ring, pol=pol, freed_t=freed_t,
            rows=rows, promo_scale=state.promo_scale, steady=state.steady,
            mitigated_prev=state.mitigated_prev,
            thrash_prev=state.thrash_prev, usage_prev=state.usage_prev,
            freed_since=state.freed_since + freed_t)

    return OwnershipProvider(
        n_pages=owner_j.shape[0], strategy=strategy, prepare=prepare,
        pool_free=lambda owner_, tier_: (tier_ == TIER_NONE).sum(
            dtype=torch.int32))


def make_tick_core(cfg: TieringConfig, provider: OwnershipProvider,
                   mode: str = "equilibria", k_max: int = 256,
                   detector=None, attrib=None, hotness=None):
    """Build the tick ``(state, inputs) -> (state', TickOutput)`` over an
    ownership provider. ``detector`` and ``attrib`` (streaming detectors,
    attribution ledger) arrive in a later slice and must be None;
    ``hotness`` must be None/"exact"."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if detector is not None or attrib is not None:
        raise NotImplementedError("detector/attrib seams are not ported yet")
    T = cfg.n_tenants
    L = provider.n_pages
    n_fast = cfg.n_fast_pages
    wmark = max(int(np.ceil(n_fast * cfg.watermark_free)), 1)
    strategy = provider.strategy
    by_tenant = strategy.by_tenant
    alloc_ranks = strategy.alloc_ranks
    hot_provider = HOT.resolve_hotness(hotness, cfg, L, k_max)

    def tick(state: TierState, inputs) -> Tuple[TierState, TickOutput]:
        t = state.t
        dev = state.tier.device
        i32 = dict(dtype=torch.int32, device=dev)
        page_ids = torch.arange(L, **i32)

        # ---- 1. ownership / lifecycle (the provider seam) -----------------
        prep = provider.prepare(state, inputs)
        owner, owner_c = prep.owner, prep.owner_c
        alive, accesses = prep.alive, prep.accesses
        tier, stats, ring = prep.tier, prep.stats, prep.ring
        pol = prep.pol
        if strategy.move is not None:
            # the move kernel commits in place; keep the caller's state intact
            ring = OT.MigrationRing(data=ring.data.clone(), head=ring.head)

        # Migration accounting runs over the selection's compact [T, k]
        # stream when available, else over the full [L] masks.
        def sel_counts(sel: SEL.Selection) -> torch.Tensor:
            if sel.counts is not None:
                return sel.counts
            return by_tenant(sel.mask.to(torch.int32), owner)

        def sel_tenants(sel: SEL.Selection) -> torch.Tensor:
            return torch.arange(T, **i32)[:, None].expand(sel.take.shape)

        def sel_thrash(tbl, sel: SEL.Selection) -> torch.Tensor:
            if sel.pages is None:
                return by_tenant(P.thrash_hits(
                    tbl, page_ids, sel.mask, t, cfg).to(torch.int32), owner)
            hits = P.thrash_hits(tbl, sel.pages, sel.take, t, cfg)
            return hits.sum(dim=1, dtype=torch.int32)

        def sel_record_promos(tbl, sel: SEL.Selection):
            if sel.pages is None:
                return P.thrash_record_promotions(tbl, page_ids, sel.mask, t)
            return P.thrash_record_promotions(tbl, sel.pages, sel.take, t)

        def sel_exits(st, sel: SEL.Selection):
            if sel.pages is None:
                return OS.record_fast_exits(st, sel.mask, owner_c, t)
            return OS.record_fast_exits_at(st, sel.pages, sel.take,
                                           sel_tenants(sel), t)

        def sel_ring(rg, sel: SEL.Selection, hotv, direction):
            if sel.pages is None:
                return OT.ring_record(rg, sel.mask, page_ids, owner_c, hotv,
                                      direction, t)
            hp = hotv[torch.clamp(sel.pages, max=L - 1).to(torch.int64)]
            return OT.ring_record(rg, sel.take, sel.pages, sel_tenants(sel),
                                  hp, direction, t)

        def move_pages(tier_, ring_, sel: SEL.Selection, hotv, direction,
                       to_tier):
            """Commit a selection's page moves: tier scatter + migration-ring
            append, through the strategy's fused move kernel when it has
            one and the selection carries the compact stream."""
            if strategy.move is not None and sel.pages is not None:
                tier2, data2, head2 = strategy.move(
                    tier_, ring_.data, ring_.head, sel, hotv, direction,
                    to_tier, t)
                return tier2, OT.MigrationRing(data=data2, head=head2)
            ring2 = sel_ring(ring_, sel, hotv, direction)
            return torch.where(sel.mask, to_tier, tier_), ring2

        # ---- 2. allocate new pages ----------------------------------------
        # Runs every tick: with ``new`` empty every output equals the
        # pass-through (wheres over a False mask, zero counts, no stamps).
        new = alive & (tier == TIER_NONE)
        fast_usage = by_tenant((tier == TIER_FAST).to(torch.int32), owner)
        fast_free = n_fast - fast_usage.sum(dtype=torch.int32)
        alloc_t = None
        if mode in ("equilibria", "memtis") and cfg.enable_upper_bound:
            if strategy.alloc_stats is not None:
                # fused kernel pass: allocation ranks + per-tenant counts
                ranks, alloc_t = strategy.alloc_stats(new, owner)
            else:
                ranks = alloc_ranks(new, owner)
            oc = owner_c.to(torch.int64)
            bound = pol.upper_bound[oc]
            under_bound = (bound == 0) | (fast_usage[oc] + ranks < bound)
        else:
            under_bound = torch.ones((L,), dtype=torch.bool, device=dev)
        elig = new & under_bound
        grank = SEL.masked_rank(elig)
        go_fast = elig & (grank < torch.clamp(fast_free - wmark, min=0))
        tier = torch.where(go_fast, TIER_FAST,
                           torch.where(new, TIER_SLOW, tier))
        if alloc_t is None:
            alloc_t = by_tenant(new.to(torch.int32), owner)
        stats = OS.record_fast_entries(stats, go_fast, t)

        # ---- 3. hotness / recency (the hotness-provider seam) -------------
        last_access = torch.where(new | (accesses > 0), t, state.last_access)
        hview = hot_provider.step(HOT.HotCtx(
            hstate=state.hotness, prev_hot=prep.hot, accesses=accesses,
            alive=alive, new=new, tier=tier, last_access=last_access,
            owner=owner, owner_c=owner_c, t=t, rows=prep.rows,
            strategy=strategy))
        hot = hview.hot

        # ---- 4. contention ------------------------------------------------
        fast_usage = by_tenant((tier == TIER_FAST).to(torch.int32), owner)
        fast_free = n_fast - fast_usage.sum(dtype=torch.int32)
        demand_t = torch.clamp(hview.demand_t, max=k_max)
        promo_demand = torch.clamp(demand_t.sum(dtype=torch.int32), max=k_max)
        contended = fast_free < wmark + promo_demand

        # ---- 5. demotion ---------------------------------------------------
        sync_quota = torch.zeros((T,), **i32)
        if mode == "equilibria":
            d_scan = P.eq1_demotion_scan(fast_usage, fast_usage, pol,
                                         contended)
            if not cfg.enable_protection:
                # ablation: proportional pressure without protection
                d_scan = torch.where(contended,
                                     fast_usage.to(torch.float32), 0.0)
            # Eq.1 sets each tenant's share of the reclaim work; the total
            # frees the watermark plus the neighbors' pending promotions
            demand_other = torch.clamp(promo_demand - demand_t, max=k_max)
            needed_t = torch.clamp(wmark + demand_other - fast_free, min=0)
            total_scan = torch.clamp(d_scan.sum(), min=1.0)
            share = torch.ceil(d_scan * torch.clamp(
                needed_t.to(torch.float32) / total_scan, max=1.0)
            ).to(torch.int32)
            if cfg.enable_upper_bound:
                sync_quota = P.upper_bound_demotion(fast_usage, pol)
            quota = torch.clamp(share + sync_quota, max=k_max)
        elif mode == "tpp":
            needed = torch.clamp(2 * wmark - fast_free, min=0)
            quota = torch.clamp(needed, max=k_max * T)  # global
        elif mode == "memtis":
            sync_quota = P.upper_bound_demotion(fast_usage, pol)
            quota = torch.clamp(sync_quota, max=k_max)
        else:  # static
            quota = torch.zeros((T,), **i32)

        fast_mask = tier == TIER_FAST
        no_sel = SEL.Selection(torch.zeros((L,), dtype=torch.bool,
                                           device=dev), None, None, None)
        if mode == "tpp":
            dsel = hview.demote_global(fast_mask, quota)
        elif mode == "static":
            dsel = no_sel
        else:
            dsel = hview.demote(fast_mask, quota)
        demoted = dsel.mask
        demo_t = sel_counts(dsel)

        # thrash detection on demotions (§IV-F)
        thrash_new = sel_thrash(prep.table, dsel)
        stats = sel_exits(stats, dsel)
        tier, ring = move_pages(tier, ring, dsel, hot, OT.DIR_DEMOTE,
                                TIER_SLOW)
        fast_usage = fast_usage - demo_t
        fast_free = n_fast - fast_usage.sum(dtype=torch.int32)

        # ---- 6. promotion ---------------------------------------------------
        # just-demoted pages are not promotion candidates this tick
        pcand = hview.promo_cand(tier, demoted)
        cand_t = pcand.cand_t
        throttled = torch.zeros((T,), dtype=torch.bool, device=dev)
        if mode == "equilibria":
            p_base = torch.full((T,), float(cfg.p_base), dtype=torch.float32,
                                device=dev)
            if cfg.enable_promo_throttle:
                p_scan, throttled = P.eq2_promotion_scan(
                    p_base, fast_usage, pol, contended, cfg)
            else:
                p_scan = p_base
            p_scan = p_scan * prep.promo_scale        # thrash mitigation
            p_quota = torch.clamp(p_scan.to(torch.int32), max=k_max)
        elif mode in ("tpp", "memtis"):
            p_quota = torch.full((T,), cfg.p_base, **i32)  # unregulated
        else:
            p_quota = torch.zeros((T,), **i32)

        # never overfill: cap total promotions by free fast capacity.
        # Promotions may transiently exceed a tenant's upper bound; the
        # allocating thread then demotes synchronously in step 6b (§IV-D).
        p_quota = torch.minimum(p_quota, torch.clamp(cand_t, max=k_max))
        headroom = torch.clamp(fast_free - wmark, min=0)
        total = p_quota.sum(dtype=torch.int32)
        scale = torch.where(total > headroom,
                            headroom.to(torch.float32)
                            / torch.clamp(total, min=1), 1.0)
        p_quota = torch.floor(p_quota.to(torch.float32) * scale
                              ).to(torch.int32)

        if mode == "tpp":
            psel = pcand.select_global(p_quota.sum(dtype=torch.int32))
        elif mode == "static":
            psel = no_sel
        else:
            psel = pcand.select(p_quota)
        promoted = psel.mask
        promo_t = sel_counts(psel)
        tier, ring = move_pages(tier, ring, psel, hot, OT.DIR_PROMOTE,
                                TIER_FAST)
        table = sel_record_promos(prep.table, psel)
        stats = OS.record_fast_entries(stats, promoted, t)

        # ---- 6b. synchronous upper-bound demotion (allocation path, §IV-D)
        sync2_t = torch.zeros((T,), **i32)
        if mode in ("equilibria", "memtis") and cfg.enable_upper_bound:
            fast_usage2 = by_tenant((tier == TIER_FAST).to(torch.int32),
                                    owner)
            over2 = torch.where(
                pol.upper_bound > 0,
                torch.clamp(fast_usage2 - pol.upper_bound, min=0), 0)
            over2 = torch.clamp(over2, max=k_max)
            ssel = hview.demote(tier == TIER_FAST, over2)
            thr2 = sel_thrash(table, ssel)
            thrash_new = thrash_new + thr2
            stats = sel_exits(stats, ssel)
            tier, ring = move_pages(tier, ring, ssel, hot, OT.DIR_DEMOTE,
                                    TIER_SLOW)
            sync2_t = sel_counts(ssel)
            demo_t = demo_t + sync2_t

        # ---- 7. counters ----------------------------------------------------
        c = state.counters
        counters = Counters(
            promotions=c.promotions + promo_t,
            demotions=c.demotions + demo_t,
            attempted_promotions=c.attempted_promotions + cand_t,
            reclaims=c.reclaims + prep.freed_t,
            allocations=c.allocations + alloc_t,
            thrash_events=c.thrash_events + thrash_new,
            sync_demotions=c.sync_demotions
            + torch.minimum(sync_quota, demo_t) + sync2_t,
        )
        fast_usage = by_tenant((tier == TIER_FAST).to(torch.int32), owner)
        slow_usage = by_tenant((tier == TIER_SLOW).to(torch.int32), owner)

        # ---- 7b. observability (obs/, §IV-C) --------------------------------
        # tpp's quota is one global scan budget; split it evenly so
        # demo_success_ratio stays comparable across modes
        demo_att = ((quota + T - 1) // T).expand(T) if quota.dim() == 0 \
            else quota
        below_prot = OS.below_protection(fast_usage, slow_usage,
                                         pol.lower_protection)
        # sync upper-bound demotions (6b) bypass the step-5 quota; count them
        # on both sides so demo_success_ratio stays <= 1
        stats = OS.update_tick(
            stats, promo_attempts=cand_t, promo_success=promo_t,
            demo_attempts=torch.clamp(demo_att, max=k_max) + sync2_t,
            demo_success=demo_t,
            thrash_new=thrash_new, contended=contended, throttled=throttled,
            below_protection=below_prot, decay=cfg.obs_window_decay)

        new_state = TierState(
            tier=tier.to(torch.int8), hot=hot, last_access=last_access,
            owner=owner, counters=counters, promo_scale=prep.promo_scale,
            thrash_prev=prep.thrash_prev, usage_prev=prep.usage_prev,
            freed_since=prep.freed_since, steady=prep.steady,
            mitigated_prev=prep.mitigated_prev,
            table=table, stats=stats, ring=ring, t=t + 1,
            hotness=hview.hstate)

        # ---- 8. periodic controller (§IV-F) ---------------------------------
        if (t + 1) % cfg.controller_period == 0:
            out = P.thrash_controller(new_state, fast_usage + slow_usage, cfg)
            new_state = new_state._replace(
                promo_scale=out.promo_scale, steady=out.steady,
                table=out.table, thrash_prev=out.thrash_prev,
                usage_prev=out.usage_prev, freed_since=out.freed_since,
                mitigated_prev=out.mitigated_prev)

        # ---- 9. perf model ---------------------------------------------------
        a_fast = by_tenant(accesses * (tier == TIER_FAST), owner)
        a_slow = by_tenant(accesses * (tier == TIER_SLOW), owner)
        a_tot = a_fast + a_slow
        migrations = (promo_t + demo_t).sum(dtype=torch.int32).to(
            torch.float32)
        # both multiply-adds with the reference's single rounding
        num = (a_fast.double() * f32(cfg.lat_fast)
               + a_slow.double() * f32(cfg.lat_slow)).to(torch.float32)
        base_lat = torch.where(a_tot > 0,
                               num / torch.clamp(a_tot, min=1e-9),
                               cfg.lat_fast)
        lat = (migrations.double() * f32(cfg.migration_cost)
               + base_lat.double()).to(torch.float32)
        thru = torch.where(a_tot > 0, a_tot / lat, 0.0)

        out = TickOutput(
            fast_usage=fast_usage, slow_usage=slow_usage,
            promotions=promo_t, demotions=demo_t,
            throughput=thru, latency=lat, promo_scale=new_state.promo_scale,
            thrash_events=counters.thrash_events,
            fast_free=n_fast - fast_usage.sum(dtype=torch.int32),
            attempted_promotions=cand_t,
            pool_free=provider.pool_free(owner, tier))
        return new_state, out

    return tick
