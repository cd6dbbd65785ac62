"""Equilibria fairness policy — the paper's equations, as tensor functions
(torch port of ``repro/core/policy.py``).

Eq. 1 (demotion modulation), Eq. 2 (promotion regulation, fourth-power
throttle with a 1/16 floor), thrashing detection/controller, and the
steady-state detector (§IV-F).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core.state import TenantPolicy, ThrashTable, TierState
from repro_torch.numerics import fused_mul_add


def eq1_demotion_scan(fast_usage: torch.Tensor, n_lru: torch.Tensor,
                      policy: TenantPolicy,
                      contended: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 1: d_scan = n_lru * (n_cgroup - n_protection) / n_cgroup.

    Zero for tenants at/below their lower protection, and unless local
    memory is contended. fast_usage, n_lru: [T] pages. Returns [T] f32."""
    n_cgroup = fast_usage.to(torch.float32)
    n_prot = policy.lower_protection.to(torch.float32)
    over = torch.clamp(n_cgroup - n_prot, min=0.0)
    d = torch.where(n_cgroup > 0,
                    n_lru.to(torch.float32) * over
                    / torch.clamp(n_cgroup, min=1.0), 0.0)
    return torch.where(contended, d, 0.0)


def upper_bound_demotion(fast_usage: torch.Tensor,
                         policy: TenantPolicy) -> torch.Tensor:
    """Upper-bound enforcement (§IV-D): once usage reaches 95% of the bound,
    demote down toward 90% (the gentle background path); any overage past
    the bound is additionally forced (sync path). Returns [T] int32 pages
    that must be demoted regardless of global pressure."""
    bound = policy.upper_bound
    bf = bound.to(torch.float32)
    # ceil(0.95 * bf - 1e-4) with the reference's single rounding (fused)
    near_thr = torch.ceil(fused_mul_add(0.95, bf, -1e-4)).to(torch.int32)
    target = torch.round(0.9 * bf).to(torch.int32)
    near = fast_usage >= near_thr
    gentle = torch.clamp(fast_usage - target, min=0)
    over = torch.clamp(fast_usage - bound, min=0)
    quota = torch.where(near, torch.maximum(gentle, over), over)
    return torch.where(bound > 0, quota, 0).to(torch.int32)


def eq2_promotion_scan(p_base: torch.Tensor, fast_usage: torch.Tensor,
                       policy: TenantPolicy, contended: torch.Tensor,
                       cfg: TieringConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Eq. 2: p_scan = p_base * clip((n_prot/n_cgroup)^4, 1/16, 1).

    A tenant is "promotion throttled" (§IV-E) when either a lower protection
    is configured, usage exceeds it and local memory is fully utilized, or
    usage is at/over 95% of its configured upper bound.
    Returns (p_scan [T] f32, throttled [T] bool)."""
    usage = fast_usage.to(torch.float32)
    prot = policy.lower_protection.to(torch.float32)
    bound = policy.upper_bound.to(torch.float32)
    over_prot = (prot > 0) & (usage > prot) & contended
    near_bound = (bound > 0) & (usage >= 0.95 * bound)
    throttled = over_prot | near_bound
    ref = torch.where(prot > 0, prot, torch.where(bound > 0, bound, usage))
    ratio = torch.where(usage > 0, ref / torch.clamp(usage, min=1.0), 1.0)
    # (r*r)*(r*r): the reference's lowering of ratio ** 4 (torch.pow rounds
    # differently, and the result is truncated to an integer quota)
    factor = torch.clamp((ratio * ratio) * (ratio * ratio),
                         cfg.promo_floor, 1.0)
    p = torch.where(throttled, p_base * factor, p_base)
    return p, throttled


# ------------------------------------------------------- thrash tracking ----
def thrash_record_promotions(table: ThrashTable, promoted_pages: torch.Tensor,
                             promoted_mask: torch.Tensor, t: int
                             ) -> ThrashTable:
    """Insert promoted pages into the direct-mapped table (slot = page % S).

    Two pages promoted in the SAME call can collide on a slot. The highest
    lane of the row-major flattened stream wins — the reference's CPU
    scatter behaviour — made deterministic on every device with an ``amax``
    over lane ids followed by a gather."""
    slots = table.page.shape[0]
    pages = promoted_pages.reshape(-1)
    mask = promoted_mask.reshape(-1)
    idx = torch.where(mask, pages % slots, slots)          # slots = dump
    lane = torch.arange(pages.shape[0], dtype=torch.int64,
                        device=pages.device)
    win = torch.full((slots + 1,), -1, dtype=torch.int64,
                     device=pages.device).scatter_reduce(
        0, idx.to(torch.int64), lane, "amax")[:slots]
    hit = win >= 0
    page = torch.where(hit, pages[torch.clamp(win, min=0)], table.page)
    tick = torch.where(hit, t, table.tick)
    return ThrashTable(page=page.to(torch.int32), tick=tick.to(torch.int32))


def thrash_hits(table: ThrashTable, demoted_pages: torch.Tensor,
                demoted_mask: torch.Tensor, t: int,
                cfg: TieringConfig) -> torch.Tensor:
    """Per-lane thrash flag: demoted page was promoted < t_resident ago."""
    slots = table.page.shape[0]
    idx = demoted_pages % slots
    hit = (table.page[idx] == demoted_pages) & demoted_mask
    recent = (t - table.tick[idx]) < cfg.t_resident
    return hit & recent


def thrash_check_demotions(table: ThrashTable, demoted_pages: torch.Tensor,
                           demoted_mask: torch.Tensor, owners: torch.Tensor,
                           t: int, cfg: TieringConfig,
                           n_tenants: int) -> torch.Tensor:
    """Count demotions of pages promoted < t_resident ago. Returns [T] int32."""
    is_thrash = thrash_hits(table, demoted_pages, demoted_mask, t, cfg)
    return torch.zeros((n_tenants,), dtype=torch.int32,
                       device=owners.device).index_add(
        0, owners.reshape(-1).to(torch.int64),
        is_thrash.reshape(-1).to(torch.int32))


class ControllerOut(NamedTuple):
    promo_scale: torch.Tensor
    steady: torch.Tensor
    table: ThrashTable
    thrash_prev: torch.Tensor
    usage_prev: torch.Tensor
    freed_since: torch.Tensor
    mitigated_prev: torch.Tensor


def thrash_controller(state: TierState, usage_total: torch.Tensor,
                      cfg: TieringConfig) -> ControllerOut:
    """Periodic controller (§IV-F, every `controller_period` ticks):
    steady-state detection, then halve/double promotion rates of thrashing
    steady-state tenants; clear the table to start the next window.

    Recovery (doubling back toward 1.0) waits for a quiet window that was
    not the window the mitigation itself fired in (``mitigated_prev``)."""
    thrash_rate = (state.counters.thrash_events
                   - state.thrash_prev).to(torch.float32)
    u = usage_total.to(torch.float32)
    prev = state.usage_prev.to(torch.float32)
    denom = torch.clamp(torch.maximum(u, prev), min=1.0)
    active_delta = torch.abs(u - prev) / denom
    free_rate = state.freed_since.to(torch.float32) / denom
    steady = ((active_delta < cfg.steady_active_delta)
              & (free_rate < cfg.steady_free_rate))

    thrashing = thrash_rate > cfg.r_thrashing
    mitigate = (steady & thrashing if cfg.enable_thrash_mitigation
                else torch.zeros_like(steady))
    recover = ~thrashing & ~state.mitigated_prev
    scale = state.promo_scale
    scale = torch.where(mitigate, torch.clamp(scale * 0.5, min=1.0 / 64.0),
                        scale)
    scale = torch.where(recover, torch.clamp(scale * 2.0, max=1.0), scale)

    page = state.table.page
    cleared = ThrashTable(page=torch.full_like(page, -1),
                          tick=torch.zeros_like(state.table.tick))
    return ControllerOut(
        promo_scale=scale, steady=steady, table=cleared,
        thrash_prev=state.counters.thrash_events,
        usage_prev=usage_total,
        freed_since=torch.zeros_like(state.freed_since),
        mitigated_prev=mitigate)
