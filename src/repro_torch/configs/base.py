"""Configuration for the port: the Equilibria fairness parameters (paper §IV).

A copy of ``TieringConfig`` from the reference's ``configs/base.py``; the
model configs arrive with the model stack.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class TieringConfig:
    """Equilibria fairness parameters (paper §IV). Page sizes are in 'pages'."""
    n_tenants: int = 4
    n_fast_pages: int = 4096          # fast-tier pool (local DRAM / HBM analogue)
    n_slow_pages: int = 4096          # slow-tier pool (CXL analogue)
    page_tokens: int = 64             # tokens per KV page (serving path)
    # per-tenant policy (paper §IV-B): lower protection and upper bound, in pages.
    lower_protection: Tuple[int, ...] = ()
    upper_bound: Tuple[int, ...] = () # 0 entries mean "no bound"
    # fair-share weights for churn-time policy re-partitioning (consumed only
    # by the dynamic-ownership engine)
    tenant_weights: Tuple[float, ...] = ()
    # demotion/promotion machinery
    watermark_free: float = 0.02      # keep this fraction of fast pages free
    p_base: int = 256                 # unthrottled promotion scan per tick (pages)
    promo_hot_threshold: float = 2.0  # hint-fault analogue: promote after ~2 accesses
    promo_floor: float = 1.0 / 16.0   # Eq.2 floor
    # thrashing mitigation (paper §IV-F)
    thrash_table_slots: int = 1024
    t_resident: int = 8               # ticks: promoted->demoted faster than this = thrash
    r_thrashing: float = 32.0         # thrash events / period threshold
    controller_period: int = 5        # ticks between controller runs (paper: 5 s)
    steady_active_delta: float = 0.05 # steady-state detector thresholds
    steady_free_rate: float = 0.05
    hot_decay: float = 0.85           # EWMA hotness decay per tick
    # perf model (simulator): latency units per access by tier (paper Fig.2 / §V-A:
    # CXL idle latency 252ns vs ~100ns local)
    lat_fast: float = 1.0
    lat_slow: float = 2.5
    migration_cost: float = 0.0005    # system-wide stall per migrated page (noisy neighbor)
    enable_protection: bool = True
    enable_upper_bound: bool = True
    enable_promo_throttle: bool = True
    enable_thrash_mitigation: bool = True
    # observability (obs/, paper §IV-C): in-graph stats + migration ring
    obs_ring_capacity: int = 4096     # migration events kept (newest wins)
    obs_resid_buckets: int = 16       # log2 residency-histogram buckets
    obs_window_decay: float = 0.9     # EWMA decay of windowed rates

    def with_(self, **kw) -> "TieringConfig":
        return dataclasses.replace(self, **kw)
