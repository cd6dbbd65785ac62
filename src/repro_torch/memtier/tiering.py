"""Equilibria tiering step over the paged KV cache (torch port of the
reference's ``memtier/tiering.py``).

Runs in the serve step after attention: EWMA-updates page hotness from
attention mass, computes per-tenant quotas with the *same* policy functions
as the OS-level simulator (``core/policy.py`` — Eq.1, Eq.2, thrash
controller), rounds them to per-sequence migrations (one page per selected
sequence per step ≈ a migration bandwidth limit), and moves the pages
between pools for all layers at once through the page-migration kernel
(``kernels/migrate``), in place: the demotion copies run before the
promotion copies, and promotion reads the slow pool after demotion, as the
reference's functional updates do. The controller runs on the host step
counter, so no device value is read back.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core import policy as P
from repro_torch.core.select import select_top_quota
from repro_torch.core.state import Counters, TenantPolicy
from repro_torch.kernels.migrate import ops as KMIG
from repro_torch.kernels.migrate import ref as KMIG_REF
from repro_torch.memtier.kvcache import (TieredKVCache, _rows, _set_rows,
                                         by_tenant, first_true)
from repro_torch.numerics import fused_mul_add
from repro_torch.obs import stats as OS
from repro_torch.obs import trace as OT

MODES = ("equilibria", "tpp", "static")


def _per_tenant_seq_select(score, eligible, tenant, quota, n_tenants: int,
                           k_per_tenant: int = 4) -> torch.Tensor:
    """Pick up to quota[t] sequences per tenant with the highest score.
    score/eligible/tenant: [B]; quota: [T]. Returns selected [B] bool."""
    B = score.shape[0]
    return select_top_quota(score, tenant, eligible, quota, n_tenants,
                            min(k_per_tenant, B))


def equilibria_kv_step(cache: TieredKVCache, fast_mass: torch.Tensor,
                       slow_mass: torch.Tensor, tcfg: TieringConfig,
                       policy: TenantPolicy, fast_budget: int,
                       mode: str = "equilibria",
                       impl: str = "cuda") -> TieredKVCache:
    """One tiering step. fast_mass/slow_mass: [B, Mf]/[B, Ms] attention mass
    averaged over layers this step (the hotness signal). impl "cuda" moves
    pages through the kernel wrapper, "ref" through its plain version."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    migrate = KMIG.migrate_pages if impl == "cuda" else \
        KMIG_REF.migrate_pages_ref
    dev = cache.fast_page.device
    B, Mf = cache.fast_page.shape
    M = cache.page_tier.shape[1]
    T = policy.lower_protection.shape[0]
    barange = torch.arange(B, dtype=torch.int32, device=dev)
    t = cache.t

    # ---- hotness EWMA (one rounding: the reference's jitted multiply-add)
    fast_used = cache.fast_page >= 0
    slow_used = cache.slow_page >= 0
    fast_hot = torch.where(fast_used, fused_mul_add(
        tcfg.hot_decay, cache.fast_hot, fast_mass), 0.0)
    slow_hot = torch.where(slow_used, fused_mul_add(
        tcfg.hot_decay, cache.slow_hot, slow_mass), 0.0)

    # ---- per-tenant usage & contention ----
    fast_cnt = fast_used.sum(dim=1, dtype=torch.int32)
    fast_usage = by_tenant(fast_cnt, cache.tenant, T)                # [T]
    global_fast = fast_cnt.sum(dtype=torch.int32)
    wmark = max(int(math.ceil(fast_budget * tcfg.watermark_free)), 1)
    slow_demand = by_tenant(
        slow_hot.amax(dim=1) >= tcfg.promo_hot_threshold, cache.tenant,
        T).sum(dtype=torch.int32)
    contended = (fast_budget - global_fast) < (wmark + slow_demand)

    # ---- quotas (paper Eq.1 / Eq.2, per tenant) ----
    throttled = torch.zeros((T,), dtype=torch.bool, device=dev)
    if mode == "equilibria":
        d_scan = P.eq1_demotion_scan(fast_usage, fast_usage, policy,
                                     contended)
        sync = P.upper_bound_demotion(fast_usage, policy)
        d_quota = torch.clamp(d_scan.to(torch.int32) + sync, max=4)
        p_base = torch.full((T,), 4.0, dtype=torch.float32, device=dev)
        p_scan, throttled = P.eq2_promotion_scan(p_base, fast_usage, policy,
                                                 contended, tcfg)
        p_quota = torch.clamp(p_scan * cache.promo_scale, min=0.0
                              ).to(torch.int32)
        bound_room = torch.where(
            policy.upper_bound > 0,
            torch.clamp(policy.upper_bound - fast_usage, min=0), p_quota)
        p_quota = torch.minimum(p_quota, bound_room)
    elif mode == "tpp":  # unregulated: demote when over budget, promote freely
        over = torch.clamp(global_fast - (fast_budget - wmark), min=0)
        d_quota = torch.clamp(over, max=4).expand(T).to(torch.int32)
        p_quota = torch.full((T,), 4, dtype=torch.int32, device=dev)
    else:  # static: no migration
        d_quota = torch.zeros((T,), dtype=torch.int32, device=dev)
        p_quota = torch.zeros((T,), dtype=torch.int32, device=dev)

    # ---- demotion: coldest fast page of selected sequences ----
    cold = torch.where(fast_used, fast_hot, float("inf"))
    src_f = torch.argmin(cold, dim=1)                              # [B]
    has_fast = fast_used.any(dim=1)
    has_slow_free = (~slow_used).any(dim=1)
    demote_sel = _per_tenant_seq_select(
        -_rows(cold, src_f), has_fast & has_slow_free, cache.tenant,
        d_quota, T)
    dst_s = first_true(~slow_used)                                 # first free

    apage_d = _rows(cache.fast_page, src_f)                        # absolute
    lpage_d = torch.clamp(apage_d, min=0) % M                      # table slot
    gpage_d = barange * (1 << 20) + torch.clamp(apage_d, min=0)    # identity
    thrash_new = P.thrash_check_demotions(
        cache.table, gpage_d, demote_sel, cache.tenant, t, tcfg, T)

    # obs: residency ends for the demoted fast slots; trace the event
    exit_mask = _set_rows(torch.zeros_like(fast_used), src_f, demote_sel)
    slot_owner = cache.tenant[:, None].expand(B, Mf)
    stats = OS.record_fast_exits(cache.stats, exit_mask, slot_owner, t)
    ring = OT.ring_record(cache.ring, demote_sel, gpage_d, cache.tenant,
                          _rows(fast_hot, src_f), OT.DIR_DEMOTE, t)

    migrate(cache.fast_k, cache.slow_k, src_f, dst_s, demote_sel)
    migrate(cache.fast_v, cache.slow_v, src_f, dst_s, demote_sel)
    slow_page = _set_rows(cache.slow_page, dst_s, torch.where(
        demote_sel, apage_d, _rows(cache.slow_page, dst_s)))
    slow_hot = _set_rows(slow_hot, dst_s, torch.where(
        demote_sel, _rows(fast_hot, src_f), _rows(slow_hot, dst_s)))
    fast_page = _set_rows(cache.fast_page, src_f, torch.where(
        demote_sel, -1, _rows(cache.fast_page, src_f)))
    fast_hot = _set_rows(fast_hot, src_f, torch.where(
        demote_sel, 0.0, _rows(fast_hot, src_f)))
    page_tier = _set_rows(cache.page_tier, lpage_d, torch.where(
        demote_sel, 1, _rows(cache.page_tier, lpage_d).to(torch.int32)))
    page_idx = _set_rows(cache.page_idx, lpage_d, torch.where(
        demote_sel, dst_s, _rows(cache.page_idx, lpage_d)))
    fast_used = fast_page >= 0
    slow_used = slow_page >= 0

    # ---- promotion: hottest slow page of selected sequences ----
    hot_s = torch.where(slow_used, slow_hot, float("-inf"))
    src_s = torch.argmax(hot_s, dim=1)
    hot_enough = _rows(hot_s, src_s) >= tcfg.promo_hot_threshold
    has_fast_free = (~fast_used).any(dim=1)
    headroom = torch.clamp(fast_budget - fast_used.sum(dtype=torch.int32)
                           - wmark, min=0)
    promote_sel = _per_tenant_seq_select(
        _rows(hot_s, src_s), hot_enough & has_fast_free, cache.tenant,
        torch.minimum(p_quota, headroom), T)
    dst_f = first_true(~fast_used)

    apage_p = _rows(slow_page, src_s)
    lpage_p = torch.clamp(apage_p, min=0) % M
    migrate(cache.slow_k, cache.fast_k, src_s, dst_f, promote_sel)
    migrate(cache.slow_v, cache.fast_v, src_s, dst_f, promote_sel)
    fast_page = _set_rows(fast_page, dst_f, torch.where(
        promote_sel, apage_p, _rows(fast_page, dst_f)))
    fast_hot = _set_rows(fast_hot, dst_f, torch.where(
        promote_sel, _rows(slow_hot, src_s), _rows(fast_hot, dst_f)))
    slow_page = _set_rows(slow_page, src_s, torch.where(
        promote_sel, -1, _rows(slow_page, src_s)))
    slow_hot = _set_rows(slow_hot, src_s, torch.where(
        promote_sel, 0.0, _rows(slow_hot, src_s)))
    page_tier = _set_rows(page_tier, lpage_p, torch.where(
        promote_sel, 0, _rows(page_tier, lpage_p).to(torch.int32)))
    page_idx = _set_rows(page_idx, lpage_p, torch.where(
        promote_sel, dst_f, _rows(page_idx, lpage_p)))

    gpage_p = barange * (1 << 20) + torch.clamp(apage_p, min=0)
    table = P.thrash_record_promotions(cache.table, gpage_p, promote_sel, t)

    # obs: promoted pages start a fast-tier residency; trace the event
    enter_mask = _set_rows(torch.zeros_like(fast_used), dst_f, promote_sel)
    stats = OS.record_fast_entries(stats, enter_mask, t)
    ring = OT.ring_record(ring, promote_sel, gpage_p, cache.tenant,
                          _rows(fast_hot, dst_f), OT.DIR_PROMOTE, t)

    # ---- counters & thrash controller ----
    promo_t = by_tenant(promote_sel, cache.tenant, T)
    demo_t = by_tenant(demote_sel, cache.tenant, T)
    att_t = by_tenant(hot_enough, cache.tenant, T)
    c = cache.counters
    counters = Counters(
        promotions=c.promotions + promo_t,
        demotions=c.demotions + demo_t,
        attempted_promotions=c.attempted_promotions + att_t,
        reclaims=c.reclaims, allocations=c.allocations,
        thrash_events=c.thrash_events + thrash_new,
        sync_demotions=c.sync_demotions)

    # obs: per-step tiering_stat roll-forward (§IV-C)
    fast_usage_now = by_tenant((fast_page >= 0).sum(dim=1, dtype=torch.int32),
                               cache.tenant, T)
    slow_usage_now = by_tenant((slow_page >= 0).sum(dim=1, dtype=torch.int32),
                               cache.tenant, T)
    below_prot = OS.below_protection(fast_usage_now, slow_usage_now,
                                     policy.lower_protection)
    stats = OS.update_tick(
        stats, promo_attempts=att_t, promo_success=promo_t,
        demo_attempts=d_quota, demo_success=demo_t, thrash_new=thrash_new,
        contended=contended, throttled=throttled,
        below_protection=below_prot, decay=tcfg.obs_window_decay)

    promo_scale, thrash_prev = cache.promo_scale, cache.thrash_prev
    steady, mitigated_prev = cache.steady, cache.mitigated_prev
    period = tcfg.controller_period
    if (t + 1) % period == 0:
        rate = (counters.thrash_events - thrash_prev).to(torch.float32)
        # decode is steady-state by construction after warmup
        steady = torch.full((T,), t > 2 * period, dtype=torch.bool,
                            device=dev)
        thrashing = rate > tcfg.r_thrashing
        mitigate = steady & thrashing
        # recovery needs a quiet window that isn't the mitigation's own
        # (same guard as core/policy.thrash_controller)
        promo_scale = torch.where(
            mitigate, torch.clamp(promo_scale * 0.5, min=1 / 64), promo_scale)
        promo_scale = torch.where(
            ~thrashing & ~mitigated_prev,
            torch.clamp(promo_scale * 2.0, max=1.0), promo_scale)
        table = table._replace(page=torch.full_like(table.page, -1))
        thrash_prev = counters.thrash_events
        mitigated_prev = mitigate

    return cache._replace(
        fast_page=fast_page, slow_page=slow_page,
        fast_hot=fast_hot, slow_hot=slow_hot,
        page_tier=page_tier, page_idx=page_idx,
        counters=counters, promo_scale=promo_scale,
        thrash_prev=thrash_prev, steady=steady,
        mitigated_prev=mitigated_prev, table=table,
        stats=stats, ring=ring, t=t + 1)
