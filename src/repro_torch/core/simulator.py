"""Trace-driven two-tier simulator: workloads -> engine -> summary metrics
(torch port of ``repro/core/simulator.py``, static rosters).

The perf model constants come from the paper (§V-A, Fig. 2: 252ns CXL vs
~100ns local, ~0.1 bandwidth ratio).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import TieringConfig
from repro_torch.core.engine import run_engine
from repro_torch.core.workloads import (TenantWorkload, build_trace,
                                        stacked_heterogeneous, suggest_policy)
from repro_torch.obs.pathology import Pathology, detect_all
from repro_torch.obs.stats import stats_summary
from repro_torch.obs.trace import decode_ring


@dataclass
class SimResult:
    """One simulated run's collected telemetry (host-side numpy).

    Fields
    ------
    mode : str
        Engine mode the run used (``equilibria``/``tpp``/``memtis``/``static``).
    fast_usage, slow_usage : np.ndarray
        [ticks, T] per-tenant page counts in each tier.
    promotions, demotions : np.ndarray
        [ticks, T] migrations performed that tick.
    throughput, latency : np.ndarray
        [ticks, T] perf-model outputs (latency in units of ``lat_fast``).
    promo_scale : np.ndarray
        [ticks, T] thrash-mitigation promotion multiplier trajectory.
    thrash_events : np.ndarray
        [ticks, T] *cumulative* §IV-F thrash detections.
    attempted : np.ndarray, optional
        [ticks, T] promotion candidates scanned that tick (obs).
    tier_stats : dict, optional
        ``obs.stats.stats_summary`` export decoded from the final state.
    migrations : np.ndarray, optional
        Decoded migration event ring (``obs.trace.EVENT_DTYPE`` records).
    migrations_dropped : int
        Ring-capacity overflow count (events overwritten before decode).
    lower_protection : tuple
        The run's configured per-tenant protections (for the detectors).
    active : np.ndarray, optional
        [ticks, T] bool tenant roster, derived from trace liveness.
    pool_free : np.ndarray, optional
        [ticks] unallocated pages.
    """
    mode: str
    fast_usage: np.ndarray
    slow_usage: np.ndarray
    promotions: np.ndarray
    demotions: np.ndarray
    throughput: np.ndarray
    latency: np.ndarray
    promo_scale: np.ndarray
    thrash_events: np.ndarray
    attempted: Optional[np.ndarray] = None
    tier_stats: Optional[dict] = None
    migrations: Optional[np.ndarray] = None
    migrations_dropped: int = 0
    lower_protection: tuple = ()
    active: Optional[np.ndarray] = None
    pool_free: Optional[np.ndarray] = None

    def steady_window(self, frac: float = 0.5) -> slice:
        n = self.fast_usage.shape[0]
        return slice(int(n * (1 - frac)), n)

    def mean_throughput(self, window: Optional[slice] = None) -> np.ndarray:
        w = window or self.steady_window()
        return self.throughput[w].mean(axis=0)

    def mean_latency(self, window: Optional[slice] = None) -> np.ndarray:
        w = window or self.steady_window()
        return self.latency[w].mean(axis=0)

    def p99_latency(self, window: Optional[slice] = None) -> np.ndarray:
        w = window or self.steady_window()
        return np.percentile(self.latency[w], 99, axis=0)

    def mean_fast(self, window: Optional[slice] = None) -> np.ndarray:
        w = window or self.steady_window()
        return self.fast_usage[w].mean(axis=0)

    def migration_rate(self, window: Optional[slice] = None) -> np.ndarray:
        w = window or self.steady_window()
        return (self.promotions[w] + self.demotions[w]).mean(axis=0)

    def pathologies(self, **kw) -> List[Pathology]:
        """Run the offline obs.pathology detectors over this run."""
        kw.setdefault("active", self.active)
        return detect_all(
            self.fast_usage, self.slow_usage, self.promotions,
            self.demotions, self.latency, self.thrash_events,
            attempted=self.attempted,
            lower_protection=self.lower_protection, **kw)


def tenant_activity(owner: np.ndarray, alive: np.ndarray,
                    n_tenants: int) -> np.ndarray:
    """[ticks, T] bool: tenant has any live page this tick (static traces)."""
    return np.stack([alive[:, owner == i].any(axis=1)
                     for i in range(n_tenants)], axis=1)


def build_result(mode: str, cfg: TieringConfig, final, outs,
                 active: Optional[np.ndarray]) -> SimResult:
    """Decode the final engine state (stats summary + migration ring) and
    pull the per-tick outputs to the host."""
    events, dropped = decode_ring(final.ring)
    host = {f: getattr(outs, f).cpu().numpy() for f in outs._fields}
    return SimResult(
        mode=mode,
        fast_usage=host["fast_usage"],
        slow_usage=host["slow_usage"],
        promotions=host["promotions"],
        demotions=host["demotions"],
        throughput=host["throughput"],
        latency=host["latency"],
        promo_scale=host["promo_scale"],
        thrash_events=host["thrash_events"],
        attempted=host["attempted_promotions"],
        tier_stats=stats_summary(final.stats),
        migrations=events,
        migrations_dropped=dropped,
        lower_protection=tuple(cfg.lower_protection[:cfg.n_tenants]),
        active=active,
        pool_free=host["pool_free"],
    )


def simulate(cfg: TieringConfig, tenants: List[TenantWorkload], ticks: int,
             mode: str = "equilibria", k_max: int = 256,
             impl: Optional[str] = None, hotness=None,
             device="cuda") -> SimResult:
    owner, accesses, alive = build_trace(tenants, ticks)
    cfg = cfg.with_(n_tenants=len(tenants))
    final, outs = run_engine(cfg, owner, accesses, alive, mode=mode,
                             k_max=k_max, impl=impl, device=device,
                             hotness=hotness)
    return build_result(mode, cfg, final, outs,
                        tenant_activity(owner, alive, cfg.n_tenants))


def compare_modes(cfg: TieringConfig, tenants: List[TenantWorkload],
                  ticks: int, modes=("equilibria", "tpp"),
                  impl: Optional[str] = None,
                  device="cuda") -> Dict[str, SimResult]:
    return {m: simulate(cfg, tenants, ticks, mode=m, impl=impl,
                        device=device) for m in modes}


# ---------------------------------------------------------------- presets ----
def _stacked(n_tenants: int) -> Tuple[TieringConfig, List[TenantWorkload]]:
    """Stacked-heterogeneous host: n heterogeneous cgroups (cache/web/CI/
    stream/bursty), fast tier sized to ~55% of the summed footprint, per-
    tenant policy derived from workload shape (``suggest_policy``)."""
    tenants = stacked_heterogeneous(n_tenants)
    prot, bound = suggest_policy(tenants)
    total = sum(w.footprint for w in tenants)
    fast = (int(total * 0.55) // 64) * 64
    cfg = TieringConfig(n_tenants=n_tenants, n_fast_pages=fast,
                        n_slow_pages=total, lower_protection=prot,
                        upper_bound=bound)
    return cfg, tenants


PRESETS: Dict[str, Callable[[], Tuple[TieringConfig, List[TenantWorkload]]]] = {
    "stacked16": lambda: _stacked(16),
    "stacked64": lambda: _stacked(64),
}


def simulate_preset(name: str, ticks: int = 300, mode: str = "equilibria",
                    k_max: int = 128, hotness=None,
                    impl: Optional[str] = None, device="cuda",
                    **cfg_overrides) -> SimResult:
    """Run a named static scenario preset (``PRESETS``). The churn presets
    arrive with dynamic ownership."""
    if name not in PRESETS:
        raise NotImplementedError(
            f"preset {name!r}: the port has {sorted(PRESETS)}")
    cfg, tenants = PRESETS[name]()
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    return simulate(cfg, tenants, ticks, mode=mode, k_max=k_max,
                    hotness=hotness, impl=impl, device=device)
