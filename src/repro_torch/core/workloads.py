"""Synthetic tenant workloads (numpy trace generators) — the port's own copy
of the reference's static generators.

Each generator produces deterministic access traces — the paper's §V-B
microbenchmarks are deterministic sequential-pass workloads, and Meta's
production workloads are modeled by their published characteristics:
  Cache  — random access over the whole footprint, ~60% hot (§V-D1)
  Web    — stable hot working set (~28GB protection), JIT-specialized (§V-D3)
  CI     — spiky footprint: linking phases are memory-intensive (§V-D2)
  TaoBench  — steady usage & access pattern (§V-C)
  SparkBench— bursty usage, varying hotness across analytics phases (§V-C)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class TenantWorkload:
    footprint: int                 # steady-state pages
    arrival: int = 0
    departure: Optional[int] = None
    pattern: str = "hotcold"       # hotcold | uniform | stream | bursty
    hot_frac: float = 0.2
    hot_rate: float = 4.0
    cold_rate: float = 0.05
    ramp: int = 10                 # ticks to ramp up footprint
    stream_window: int = 0         # stream: hot-window size (pages)
    stream_step: int = 0           # stream: window advance per tick
    phase_len: int = 0             # bursty: footprint pulse period
    burst_low: float = 0.3         # bursty: low-phase footprint fraction
    rotate_hot_every: int = 0      # hotcold: rotate hot set (phase changes)


def _footprint_at(w: TenantWorkload, age: int) -> int:
    """Live footprint (pages) of a workload at episode-age ``age``."""
    n = w.footprint
    f = n if age >= w.ramp else max(int(n * (age + 1) / w.ramp), 1)
    if w.pattern == "bursty" and w.phase_len > 0:
        phase = (age // w.phase_len) % 2
        low = max(int(n * w.burst_low), 1)
        if phase == 1:
            f = low
        else:
            # allocations grow through the active phase (the burst
            # frontier is fresh data — see spark_like)
            pa = age % w.phase_len
            grow = min(1.0, (pa + 1) / max(w.phase_len // 2, 1))
            f = low + int((n - low) * grow)
    return f


def _rates_at(w: TenantWorkload, age: int, f: int) -> np.ndarray:
    """Per-page access rates over the tenant-local address space [0, f)."""
    rates = np.full(f, w.cold_rate, np.float32)
    if w.pattern == "uniform":
        rates[:] = w.hot_rate
    elif w.pattern in ("hotcold", "bursty"):
        h = max(int(f * w.hot_frac), 1)
        if w.pattern == "bursty" and w.rotate_hot_every == 0:
            # bursty working data is the freshest allocation (tail)
            start = max(f - h, 0)
        elif w.rotate_hot_every > 0:
            start = ((age // w.rotate_hot_every) * h) % max(f - h, 1)
        else:
            start = 0
        rates[start:start + h] = w.hot_rate
    elif w.pattern == "stream":
        win = min(max(w.stream_window, 1), f)
        start = (age * max(w.stream_step, 1)) % f
        end = start + win
        rates[start:min(end, f)] = w.hot_rate
        if end > f:  # wrap
            rates[:end - f] = w.hot_rate
    return rates


def build_trace(tenants: List[TenantWorkload], ticks: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (owner [L], accesses [ticks, L] f32, alive [ticks, L] bool)."""
    sizes = [w.footprint for w in tenants]
    base = np.cumsum([0] + sizes)
    L = int(base[-1])
    owner = np.zeros(L, np.int32)
    for i, w in enumerate(tenants):
        owner[base[i]:base[i + 1]] = i

    accesses = np.zeros((ticks, L), np.float32)
    alive = np.zeros((ticks, L), bool)

    for i, w in enumerate(tenants):
        lo = base[i]
        for t in range(ticks):
            if t < w.arrival or (w.departure is not None and t >= w.departure):
                continue
            age = t - w.arrival
            f = _footprint_at(w, age)
            alive[t, lo:lo + f] = True
            accesses[t, lo:lo + f] = _rates_at(w, age, f)
    return owner, accesses, alive


# ------------------------------------------------ paper workload analogues ----
def microbenchmark(footprint: int, arrival: int = 0, hotness: float = 1.0,
                   ramp: int = 10) -> TenantWorkload:
    """§V-B sequential-pass microbenchmark: uniform accesses at a hotness level."""
    return TenantWorkload(footprint=footprint, arrival=arrival,
                          pattern="uniform", hot_rate=4.0 * hotness, ramp=ramp)


def thrasher(footprint: int, fast_share: int, arrival: int = 0) -> TenantWorkload:
    """§V-B5: hot enough to trigger promotion, but pages are not re-accessed
    before demotion — a rotating window larger than the tenant's fast share."""
    return TenantWorkload(
        footprint=footprint, arrival=arrival, pattern="stream",
        stream_window=max(2 * fast_share, 8), stream_step=max(fast_share // 2, 4),
        hot_rate=4.0, cold_rate=0.0)


def cache_like(footprint: int, arrival: int = 0) -> TenantWorkload:
    """§V-D1 Cache: random accesses over the whole space, up to 60% hot."""
    return TenantWorkload(footprint=footprint, arrival=arrival,
                          pattern="hotcold", hot_frac=0.6, hot_rate=3.0,
                          cold_rate=0.3)


def web_like(footprint: int, arrival: int = 0, hot_pages: int = 0) -> TenantWorkload:
    """§V-D3 Web: stable modest hot set (profiling-derived protection)."""
    hf = hot_pages / footprint if hot_pages else 0.35
    return TenantWorkload(footprint=footprint, arrival=arrival,
                          pattern="hotcold", hot_frac=hf, hot_rate=4.0,
                          cold_rate=0.02)


def ci_like(footprint: int, arrival: int = 0, phase_len: int = 40) -> TenantWorkload:
    """§V-D2 CI: spiky usage — linking phases are memory-intensive."""
    return TenantWorkload(footprint=footprint, arrival=arrival, pattern="bursty",
                          phase_len=phase_len, burst_low=0.35, hot_frac=0.5,
                          hot_rate=3.0, cold_rate=0.2, ramp=15)


def tao_like(footprint: int, arrival: int = 0) -> TenantWorkload:
    """§V-C TaoBench: steady usage, hot caching access pattern (ramps up and
    consumes memory — the paper's Fig. 7 squeeze)."""
    return TenantWorkload(footprint=footprint, arrival=arrival,
                          pattern="hotcold", hot_frac=0.6, hot_rate=5.0,
                          cold_rate=2.0, ramp=40)


def spark_like(footprint: int, arrival: int = 0) -> TenantWorkload:
    """§V-C SparkBench: bursty usage; analytics phases shift the hot set, so
    its pages "manifest as less hot" than the cache workloads' — under
    system-level tiering it is forced into the slow tier (paper Fig. 7)."""
    return TenantWorkload(footprint=footprint, arrival=arrival, pattern="bursty",
                          phase_len=30, burst_low=0.25, hot_frac=0.3,
                          hot_rate=1.5, cold_rate=0.05, ramp=8)


def stream_like(footprint: int, arrival: int = 0) -> TenantWorkload:
    """Sequential scanner (ETL/media style): a hot window sweeping the
    footprint — pages get hot once, then cool. Unlike ``thrasher`` the window
    is modest, so a bounded fast share serves it without churn."""
    return TenantWorkload(
        footprint=footprint, arrival=arrival, pattern="stream",
        stream_window=max(footprint // 8, 4),
        stream_step=max(footprint // 32, 1), hot_rate=3.0, cold_rate=0.05)


# ----------------------------------------------- stacked-host scenarios ----
def stacked_heterogeneous(n_tenants: int = 16,
                          base_footprint: int = 96) -> List[TenantWorkload]:
    """Equilibria's target deployment (§V): many heterogeneous cgroups
    stacked on one host. Cycles cache/web/CI/stream/bursty generators with
    staggered arrivals and varied footprints; deterministic in n_tenants."""
    kinds = (cache_like, web_like, ci_like, stream_like, spark_like)
    out = []
    for i in range(n_tenants):
        make = kinds[i % len(kinds)]
        footprint = base_footprint + 8 * ((i * 5) % 7)
        arrival = 6 * (i % 5)
        out.append(make(footprint, arrival=arrival))
    return out


def suggest_policy(tenants: List[TenantWorkload]
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Derive per-tenant (lower_protection, upper_bound) from workload shape,
    the way operators would from profiling (paper §IV-B / §V-D): protect the
    stable hot set of hot/cold workloads, cap sweeping streamers, leave
    bursty analytics unconfigured (they donate when idle)."""
    prot, bound = [], []
    for w in tenants:
        if w.pattern == "hotcold":
            prot.append(int(w.footprint * w.hot_frac * 0.8))
            bound.append(0)
        elif w.pattern == "stream":
            prot.append(0)
            bound.append(max(2 * w.stream_window, 16))
        else:                      # bursty / uniform: no knobs configured
            prot.append(0)
            bound.append(0)
    return tuple(prot), tuple(bound)
