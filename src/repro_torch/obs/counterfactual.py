"""Counterfactual interference baselines: each tenant re-run alone on the
same hardware and schedule (torch port of ``repro/obs/counterfactual.py``).

For each tenant the schedule is masked so only that tenant's slot is
populated (``want``/``rates`` of every other slot zeroed), and the T
isolated runs advance through the same tick function as the stacked run,
one run after another (the reference batches them under ``vmap``; runs
never interact, so the results are the same) — same policy, same pool,
same horizon.

The interference index is the isolated-minus-stacked fast-hit fraction
(share of access mass served from the fast tier, from the attribution
ledger's ``acc_fast``/``acc_slow``):

    interference[i] = fast_hit_isolated[i] - fast_hit_stacked[i]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core.churn import ChurnSchedule, make_churn_tick
from repro_torch.core.engine import resolve_impl
from repro_torch.core.state import init_state, stack_hosts
from repro_torch.device import resolve_device
from repro_torch.obs.attribution import (AttributionSpec, fast_hit_fraction,
                                         make_attribution)


@dataclass
class CounterfactualResult:
    """Per-tenant stacked-vs-isolated comparison (all [T] numpy)."""
    fast_hit_stacked: np.ndarray    # fast-hit fraction, tenants stacked
    fast_hit_isolated: np.ndarray   # ... each tenant alone on the host
    interference: np.ndarray        # isolated - stacked (>= 0 expected)
    stall_stacked: np.ndarray       # mean modeled stall latency, stacked
    stall_isolated: np.ndarray      # ... isolated
    active: np.ndarray              # bool: slot ever scheduled
    stacked_state: object = None    # final TierState of the stacked run
    isolated_states: object = None  # host-stacked [T, ...] final TierStates

    def summary(self) -> dict:
        act = self.active
        return {
            "tenants": int(self.active.shape[0]),
            "active_tenants": int(act.sum()),
            "interference": self.interference,
            "max_interference": float(self.interference[act].max())
            if act.any() else 0.0,
            "mean_interference": float(self.interference[act].mean())
            if act.any() else 0.0,
            "stall_amplification": np.where(
                self.stall_isolated > 1e-9,
                self.stall_stacked / np.maximum(self.stall_isolated, 1e-9),
                np.where(self.stall_stacked > 1e-9, np.inf, 1.0)),
        }


def isolate_schedules(schedule: ChurnSchedule
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Mask a [ticks, T] churn schedule into T single-tenant schedules:
    (want [T, ticks, T], rates [T, ticks, T, S]) where run i keeps only
    tenant i's slot populated."""
    want = np.asarray(schedule.want)
    rates = np.asarray(schedule.rates)
    T = want.shape[1]
    eye = np.eye(T)
    want_iso = (want[None] * eye[:, None, :]).astype(want.dtype)
    rates_iso = (rates[None] * eye[:, None, :, None]).astype(rates.dtype)
    return want_iso, rates_iso


def counterfactual_run(cfg: TieringConfig, schedule: ChurnSchedule,
                       mode: str = "equilibria", k_max: int = 64,
                       n_pages: Optional[int] = None,
                       spec: Optional[AttributionSpec] = None,
                       impl: Optional[str] = None, device="cuda"
                       ) -> CounterfactualResult:
    """Run the stacked schedule once and every tenant's isolated schedule
    after it, all through one attribution-carrying dynamic-ownership tick.
    ``impl``: the selection core ("cuda" on a card, "ref" on the CPU by
    default; "batched" the composite sort)."""
    dev = resolve_device(device)
    impl = resolve_impl(impl, dev)
    T = cfg.n_tenants
    L = n_pages if n_pages is not None else \
        cfg.n_fast_pages + cfg.n_slow_pages
    spec = make_attribution(T, cfg.lat_fast) if spec is None else spec
    tick = make_churn_tick(cfg, L, mode=mode, k_max=k_max, attrib=spec,
                           impl=impl, device=dev)

    def run(want: np.ndarray, rates: np.ndarray):
        state = init_state(cfg, L, device=dev, attrib=spec)
        r = torch.as_tensor(np.asarray(rates, np.float32), device=dev)
        w = torch.as_tensor(np.asarray(want, np.int32), device=dev)
        for i in range(w.shape[0]):
            state, _ = tick(state, (r[i], w[i]))
        return state

    stacked = run(schedule.want, schedule.rates)
    want_iso, rates_iso = isolate_schedules(schedule)
    isolated = stack_hosts([run(want_iso[i], rates_iso[i])
                            for i in range(T)])

    f_stacked = fast_hit_fraction(stacked.attrib)              # [T]
    f_iso = fast_hit_fraction(isolated.attrib)                 # [T, T]
    f_iso_diag = np.diagonal(f_iso).copy()
    active = np.asarray(schedule.want).max(axis=0) > 0
    ticks = max(int(stacked.attrib.ticks), 1)
    stall_stacked = stacked.attrib.stall_sum.cpu().numpy().astype(
        np.float64) / ticks
    stall_iso = np.diagonal(isolated.attrib.stall_sum.cpu().numpy().astype(
        np.float64)).copy() / ticks
    interference = np.where(active, f_iso_diag - f_stacked, 0.0)
    return CounterfactualResult(
        fast_hit_stacked=f_stacked, fast_hit_isolated=f_iso_diag,
        interference=interference,
        stall_stacked=np.where(active, stall_stacked, 0.0),
        stall_isolated=np.where(active, stall_iso, 0.0),
        active=active,
        stacked_state=stacked, isolated_states=isolated)
