"""Equilibria state: page metadata, per-tenant counters, thrash table (torch
port of ``repro/core/state.py``).

State is a NamedTuple of tensors. Pages are *logical*: in the static engine
each tenant owns a fixed contiguous range of logical page ids. ``tier`` is
the dynamic placement: 0 = fast (local DRAM analogue), 1 = slow (CXL
analogue), -1 = not allocated.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.device import resolve_device
from repro_torch.obs.stats import TierStats, init_stats, stats_export
from repro_torch.obs.trace import MigrationRing, init_ring

TIER_NONE = -1
TIER_FAST = 0
TIER_SLOW = 1


class TenantPolicy(NamedTuple):
    """Static per-tenant fairness policy (paper §IV-B), in pages."""
    lower_protection: torch.Tensor   # [T] int32; 0 = no protection
    upper_bound: torch.Tensor        # [T] int32; 0 = unbounded


class Counters(NamedTuple):
    """Per-tenant observability (paper §IV-C — the cgroup tier_stat analogue)."""
    promotions: torch.Tensor          # [T] int32: pages promoted (pgpromote)
    demotions: torch.Tensor           # [T] int32: pages demoted (pgdemote)
    attempted_promotions: torch.Tensor  # [T] int32: candidates scanned
    reclaims: torch.Tensor            # [T] int32: pages freed
    allocations: torch.Tensor         # [T] int32: pages allocated
    thrash_events: torch.Tensor       # [T] int32: promote->demote under t_resident
    sync_demotions: torch.Tensor      # [T] int32: allocation-path (upper-bound) demotes


class ThrashTable(NamedTuple):
    """Fixed-size direct-mapped table of recently-promoted pages (§IV-F).

    slot = page_id % slots; collisions are the paper's 'sampling'."""
    page: torch.Tensor               # [slots] int32, -1 empty
    tick: torch.Tensor               # [slots] int32 promotion time


class TierState(NamedTuple):
    # page metadata [L]
    tier: torch.Tensor               # int8: -1/0/1
    hot: torch.Tensor                # f32 EWMA access rate
    last_access: torch.Tensor        # int32 tick
    owner: torch.Tensor              # int32 tenant id (constant in the static engine)
    # tenant state [T]
    counters: Counters
    promo_scale: torch.Tensor        # f32: thrash-mitigation promotion multiplier
    thrash_prev: torch.Tensor        # int32: thrash_events at last controller run
    usage_prev: torch.Tensor         # int32: total usage at last controller run
    freed_since: torch.Tensor        # int32: pages freed since last controller run
    steady: torch.Tensor             # bool: steady-state flag (set by controller)
    mitigated_prev: torch.Tensor     # bool: mitigation fired at last controller run
    table: ThrashTable
    # observability (obs/, §IV-C): stats + migration event ring
    stats: TierStats
    ring: MigrationRing
    t: int                           # host-side tick counter
    # streaming pathology detectors (obs/streaming.py DetectorState) and
    # the slowdown-attribution ledger (obs/attribution.py
    # AttributionState); None unless the tick was built with them
    det: Optional[Any] = None
    attrib: Optional[Any] = None
    # hotness-provider state (core/hotness.py): None for the stateless
    # providers (exact/sampled), a SketchState/NeomemState otherwise
    hotness: Optional[Any] = None


def zero_counters(n_tenants: int, device="cuda") -> Counters:
    device = resolve_device(device)
    return Counters(*(torch.zeros((n_tenants,), dtype=torch.int32,
                                  device=device) for _ in range(7)))


def init_state(cfg: TieringConfig, n_pages: int, owner=None, device="cuda",
               hotness=None, detector=None, attrib=None) -> TierState:
    """``owner``: [n_pages] int tenant ids, or None for an all-free pool
    (owner = T, the dynamic-ownership tick's starting point). ``hotness``: a
    hotness-provider spec (core/hotness.py) whose state the TierState
    carries; ``detector``: a ``DetectorSpec`` to carry the streaming
    pathology detectors; ``attrib``: an ``AttributionSpec`` to carry the
    slowdown-attribution ledger. Each must match the spec given to the tick
    builder."""
    from repro_torch.core.hotness import init_hotness  # state <-> hotness
    from repro_torch.obs.attribution import init_attribution
    from repro_torch.obs.streaming import init_detector
    device = resolve_device(device)
    T = cfg.n_tenants
    owner_t = (torch.full((n_pages,), T, dtype=torch.int32, device=device)
               if owner is None else
               torch.as_tensor(np.asarray(owner, np.int32), device=device))
    return TierState(
        tier=torch.full((n_pages,), TIER_NONE, dtype=torch.int8, device=device),
        hot=torch.zeros((n_pages,), dtype=torch.float32, device=device),
        last_access=torch.zeros((n_pages,), dtype=torch.int32, device=device),
        owner=owner_t,
        counters=zero_counters(T, device),
        promo_scale=torch.ones((T,), dtype=torch.float32, device=device),
        thrash_prev=torch.zeros((T,), dtype=torch.int32, device=device),
        usage_prev=torch.zeros((T,), dtype=torch.int32, device=device),
        freed_since=torch.zeros((T,), dtype=torch.int32, device=device),
        steady=torch.zeros((T,), dtype=torch.bool, device=device),
        mitigated_prev=torch.zeros((T,), dtype=torch.bool, device=device),
        table=ThrashTable(
            page=torch.full((cfg.thrash_table_slots,), -1, dtype=torch.int32,
                            device=device),
            tick=torch.zeros((cfg.thrash_table_slots,), dtype=torch.int32,
                             device=device)),
        stats=init_stats(T, (n_pages,), cfg.obs_resid_buckets, device),
        ring=init_ring(cfg.obs_ring_capacity, device),
        t=0,
        det=None if detector is None else init_detector(detector, device),
        attrib=None if attrib is None else init_attribution(attrib, device),
        hotness=init_hotness(hotness, cfg, n_pages, device),
    )


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a tree of NamedTuples (``None``
    subtrees stay None; the host tick counter ``t`` and other non-tensor
    leaves are taken from ``tree``)."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                             for f in tree._fields))
    return tree


def stack_hosts(states: list):
    """A fleet's per-host states (one tick function advances each host in
    turn) stacked along a leading host axis: every tensor leaf ``x`` becomes
    ``[H, *x.shape]``. The reference batches hosts with ``vmap`` over
    ``stack_states``; here the stack is only for results."""
    ts = {getattr(s, "t", None) for s in states}
    if len(ts) > 1:
        raise ValueError(f"hosts are at different ticks: {sorted(ts)}")
    return tree_map(lambda *xs: torch.stack(xs), states[0], *states[1:])


def host_slice(tree, host: int):
    """One host's subtree of a host-stacked tree (``stack_hosts``)."""
    return tree_map(lambda x: x[host], tree)


def make_policy(cfg: TieringConfig, device="cuda") -> TenantPolicy:
    device = resolve_device(device)
    T = cfg.n_tenants
    prot = np.zeros(T, np.int32)
    bound = np.zeros(T, np.int32)
    for i, v in enumerate(cfg.lower_protection[:T]):
        prot[i] = v
    for i, v in enumerate(cfg.upper_bound[:T]):
        bound[i] = v
    return TenantPolicy(torch.as_tensor(prot, device=device),
                        torch.as_tensor(bound, device=device))


def tenant_usage(state: TierState, owner_onehot: torch.Tensor):
    """owner_onehot: [T, L] static ownership. Returns (fast[T], slow[T]) page
    counts (int32)."""
    oh = owner_onehot.to(torch.bool)
    fast = (oh & (state.tier == TIER_FAST)[None]).sum(1, dtype=torch.int32)
    slow = (oh & (state.tier == TIER_SLOW)[None]).sum(1, dtype=torch.int32)
    return fast, slow


def tier_stat(state: TierState, owner_onehot: torch.Tensor,
              page_bytes: int = 1 << 24):
    """Observability export — the cgroup `memory.tier_stat` analogue (§IV-C).

    Cumulative counters come from ``Counters``; the distributional and
    windowed fields come from ``obs.TierStats``. Usage bytes are int32, as in
    the reference."""
    fast, slow = tenant_usage(state, owner_onehot)
    c = state.counters
    stat = {
        "local_usage_bytes": fast * page_bytes,
        "cxl_usage_bytes": slow * page_bytes,
        "pgpromote": c.promotions,
        "pgdemote": c.demotions,
        "pgpromote_attempted": c.attempted_promotions,
        "pgreclaim": c.reclaims,
        "pgalloc": c.allocations,
        "thrash_events": c.thrash_events,
        "sync_demotions": c.sync_demotions,
        "promo_rate_scale": state.promo_scale,
        "steady_state": state.steady,
    }
    stat.update(stats_export(state.stats))
    return stat
