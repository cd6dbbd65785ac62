"""Per-tenant slowdown attribution: a causal ledger of where tiering cost
lands, folded into the tick (core/tick.py step 9c; torch port of
``repro/obs/attribution.py``).

Each tick the promotion pipeline emits an integer deferral count per
tenant: hot slow-resident pages that wanted the fast tier but were not
promoted, plus pages the lifecycle step freed under reclaim. The total is
split into additive causes by telescoping the pipeline's quota cascade:

  quota_base = min(p_base, cand, k_max)      unthrottled scan promise
  quota_eq2  = after the Eq.2 fair-share throttle
  quota_mit  = after the thrash-mitigation promo_scale
  promoted   = pages actually promoted

  hot_resident = cand - quota_base      demand beyond any scan budget
  throttled    = quota_base - quota_eq2 deferred by fair-share (Eq.2)
  mitigated    = quota_eq2 - quota_mit  deferred by thrash suppression
  contention   = quota_mit - promoted   fast-tier headroom / floor
  reclaim      = freed                  churn reclaim stalls

Conservation (exact in int32): components sum to ``cand - promoted +
freed`` every tick, so the ledger equals ``attempted_promotions -
promotions + reclaims`` of the run's ``Counters``. Under tpp the global
selection can give one tenant more promotions than its own cap; the
negative residual folds into ``hot_resident``, so every component stays
non-negative in every mode.

The ledger also sums the perf model's access masses, a modeled stall
latency and a per-host quantile sketch (obs/sketch.py) of per-tenant-tick
stall units.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device, to_host
from repro_torch.numerics import f32
from repro_torch.obs import sketch as SK

# fixed component order of the trailing axis of AttributionState.comp
COMPONENTS = ("hot_resident", "throttled", "mitigated", "reclaim",
              "contention")
N_COMP = len(COMPONENTS)


@dataclass(frozen=True)
class AttributionSpec:
    """Python constants of the ledger."""
    n_tenants: int
    lat_fast: float = 1.0      # cfg.lat_fast: stall latency baseline


def make_attribution(n_tenants: int, lat_fast: float = 1.0) -> AttributionSpec:
    return AttributionSpec(n_tenants=n_tenants, lat_fast=float(lat_fast))


class AttribSignals(NamedTuple):
    """One tick's promotion-pipeline telemetry, all [T]."""
    cand: torch.Tensor         # int32 promotion candidates (hot slow-resident)
    promoted: torch.Tensor     # int32 pages actually promoted
    quota_base: torch.Tensor   # int32 min(p_base, cand, k_max)
    quota_eq2: torch.Tensor    # int32 ... after the Eq.2 throttle
    quota_mit: torch.Tensor    # int32 ... after thrash-mitigation promo_scale
    freed: torch.Tensor        # int32 pages freed by lifecycle reclaim
    a_fast: torch.Tensor       # f32 fast-tier access mass (perf model)
    a_slow: torch.Tensor       # f32 slow-tier access mass
    latency: torch.Tensor      # f32 modeled mean access latency


class AttributionState(NamedTuple):
    """Tick-carried ledger: O(T) per host plus one fixed-size sketch."""
    comp: torch.Tensor         # [T, N_COMP] int32 cumulative stall components
    total: torch.Tensor        # [T] int32 cumulative total stall units
    acc_fast: torch.Tensor     # [T] f32 cumulative fast access mass
    acc_slow: torch.Tensor     # [T] f32 cumulative slow access mass
    stall_sum: torch.Tensor    # [T] f32 cumulative modeled stall latency
    ticks: torch.Tensor        # 0-d int32 ticks folded
    sketch: torch.Tensor       # [SKETCH_BUCKETS] int32 per-tenant-tick stalls


def init_attribution(spec: AttributionSpec, device="cuda") -> AttributionState:
    device = resolve_device(device)
    T = spec.n_tenants
    f = dict(dtype=torch.float32, device=device)
    return AttributionState(
        comp=torch.zeros((T, N_COMP), dtype=torch.int32, device=device),
        total=torch.zeros((T,), dtype=torch.int32, device=device),
        acc_fast=torch.zeros((T,), **f), acc_slow=torch.zeros((T,), **f),
        stall_sum=torch.zeros((T,), **f),
        ticks=torch.zeros((), dtype=torch.int32, device=device),
        sketch=SK.init_sketch(device=device))


def attribution_components(sig: AttribSignals) -> torch.Tensor:
    """[T, N_COMP] int32 stall components for one tick (order COMPONENTS).
    The row sum is exactly ``cand - promoted + freed``; the tpp
    global-selection residual folds into hot_resident."""
    i32 = torch.int32
    x1 = (sig.cand - sig.quota_base).to(i32)
    x2 = (sig.quota_base - sig.quota_eq2).to(i32)
    x3 = (sig.quota_eq2 - sig.quota_mit).to(i32)
    x4 = (sig.quota_mit - sig.promoted).to(i32)
    contention = torch.clamp(x4, min=0)
    hot_resident = x1 + torch.clamp(x4, max=0)
    return torch.stack(
        [hot_resident, x2, x3, sig.freed.to(i32), contention], dim=-1)


def update_attribution(spec: AttributionSpec, att: AttributionState,
                       sig: AttribSignals) -> AttributionState:
    """Fold one tick's signals into the ledger."""
    comp_new = attribution_components(sig)
    total_new = comp_new.sum(dim=-1, dtype=torch.int32)
    stall = torch.clamp(sig.latency - f32(spec.lat_fast), min=0.0)
    return AttributionState(
        comp=att.comp + comp_new,
        total=att.total + total_new,
        acc_fast=att.acc_fast + sig.a_fast,
        acc_slow=att.acc_slow + sig.a_slow,
        stall_sum=att.stall_sum + stall,
        ticks=att.ticks + 1,
        sketch=SK.sketch_add(att.sketch, total_new))


# ------------------------------------------------------------ host side ----
def fast_hit_fraction(att: AttributionState) -> np.ndarray:
    """Per-tenant fraction of access mass served from the fast tier over the
    run; a tenant with no accesses counts as all-fast (1.0). A single host
    [T] or a stacked fleet [H, T]."""
    af = to_host(att.acc_fast).astype(np.float64)
    as_ = to_host(att.acc_slow).astype(np.float64)
    tot = af + as_
    return np.where(tot > 0, af / np.maximum(tot, 1e-30), 1.0)


def attribution_conserved(att: AttributionState, counters=None) -> bool:
    """Components sum to the total ledger and stay non-negative, and (when
    the run's ``Counters`` are given) the total equals ``attempted -
    promotions + reclaims``; exact in integers."""
    comp = to_host(att.comp).astype(np.int64)
    total = to_host(att.total).astype(np.int64)
    ok = bool((comp.sum(axis=-1) == total).all() and (comp >= 0).all())
    if counters is not None:
        expect = (to_host(counters.attempted_promotions).astype(np.int64)
                  - to_host(counters.promotions).astype(np.int64)
                  + to_host(counters.reclaims).astype(np.int64))
        ok = ok and bool((total == expect).all())
    return ok


def attribution_summary(spec: AttributionSpec,
                        att: AttributionState) -> dict:
    """Plain-numpy operator view of one host's ledger."""
    comp = to_host(att.comp).astype(np.int64)
    if comp.ndim == 3:
        raise ValueError("got a batched AttributionState; index the host "
                         "axis first (state.host_slice(att, h))")
    total = to_host(att.total).astype(np.int64)
    ticks = max(int(to_host(att.ticks)), 1)
    denom = np.maximum(total, 1).astype(np.float64)
    return {
        "components": comp,                       # [T, N_COMP]
        "component_names": COMPONENTS,
        "total": total,                           # [T]
        "component_share": comp / denom[:, None],
        "stall_units_per_tick": total / ticks,
        "stall_latency_mean": to_host(att.stall_sum).astype(np.float64) / ticks,
        "fast_hit_fraction": fast_hit_fraction(att),
        "ticks": ticks,
    }
