"""Offline pathology detectors over collected telemetry (paper §IV-C: the
observability that lets operators "diagnose performance pathologies at
scale").

Each detector consumes per-tick per-tenant numpy arrays (as produced by
``core.simulator.SimResult`` or the fleet harness) plus the static policy,
and returns ``Pathology`` records. Detectors are pure host-side numpy —
they run after collection, never in the compiled graph.

Detected pathologies (names follow the paper's failure-mode discussion):
  chronic_thrashing     — sustained promote->demote churn (§IV-F signature)
  protection_violation  — a tenant with demand above its lower protection is
                          held below it (§IV-B invariant broken)
  noisy_neighbor        — one tenant's migration traffic dominates while
                          neighbors' latency degrades (§III-F)
  promotion_stall       — promotion demand exists but success ratio stays
                          ~zero (misconfigured bound / starved promoter)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

# Default thresholds — ONE source of truth shared with the streaming
# in-graph detectors (obs/streaming.py builds its DetectorSpec from these,
# so the offline and online state machines can never drift apart).
STEADY_FRAC = 0.5            # _steady: judge the last half of the run
RESIDENT_MIN_FRAC = 0.5      # _tenant_in_window churn gate
THRASH_WINDOW = 20           # ticks per thrash-rate window
THRASH_RATE_THRESHOLD = 4.0  # events/window that makes a window "bad"
THRASH_FRAC_THRESHOLD = 0.5  # bad-window fraction that flags a tenant
PROT_TOLERANCE = 0.05        # slack below lower protection before violating
PROT_FRAC_THRESHOLD = 0.25   # violating-tick fraction that flags
NOISY_DOMINANCE = 0.5        # migration-traffic share that dominates
NOISY_DEGRADE = 1.10         # neighbor latency degrade vs early baseline
STALL_MIN_ATTEMPTS = 1.0     # attempts/tick that counts as sustained demand
STALL_SUCCESS = 0.02         # success ratio below which promotion "stalls"


@dataclass(frozen=True)
class Pathology:
    kind: str
    tenant: int
    severity: float              # >= 1.0 means "over threshold"
    evidence: Dict[str, float] = field(default_factory=dict)

    def __str__(self):
        ev = " ".join(f"{k}={v:.3g}" for k, v in self.evidence.items())
        return (f"[{self.kind}] tenant{self.tenant} "
                f"severity={self.severity:.2f} {ev}")


def _steady(n_ticks: int, frac: float = STEADY_FRAC) -> slice:
    return slice(int(n_ticks * (1 - frac)), n_ticks)


def _tenant_in_window(active: Optional[np.ndarray], w: slice, tenant: int,
                      min_frac: float = RESIDENT_MIN_FRAC) -> bool:
    """Churn gate: with a per-tick roster (``active`` [ticks, T] bool), a
    tenant is only judged over a window it meaningfully occupied — resident
    for >= ``min_frac`` of the window AND still resident at its end. A
    tenant that departed mid-window has no steady state to violate; judging
    its truncated tail produces exactly the false positives the churn tests
    pin (departure is not a protection violation or a promotion stall)."""
    if active is None:
        return True
    a = np.asarray(active[w, tenant], bool)
    if a.size == 0:
        return False
    return bool(a[-1]) and float(a.mean()) >= min_frac


def detect_chronic_thrashing(thrash_events: np.ndarray,
                             window: int = THRASH_WINDOW,
                             rate_threshold: float = THRASH_RATE_THRESHOLD,
                             frac_threshold: float = THRASH_FRAC_THRESHOLD,
                             active: Optional[np.ndarray] = None
                             ) -> List[Pathology]:
    """thrash_events: [ticks, T] *cumulative*. Flags tenants whose per-window
    thrash rate exceeds ``rate_threshold`` in >= ``frac_threshold`` of the
    steady-half windows — transient churn at arrival does not count.

    Thrashing is *history*, so (unlike protection violation / promotion
    stall) a tenant that departed mid-observation-window is still judged —
    but only over the windows it fully resided in. Without the ``active``
    roster, a departed thrasher's post-departure windows (rate 0) dilute
    its bad-window fraction and it can slip under the threshold entirely (a
    churn false *negative*, pinned by tests/test_churn.py)."""
    ticks, T = thrash_events.shape
    w = _steady(ticks)
    ev = thrash_events[w]
    if ev.shape[0] < 2 * window:
        window = max(ev.shape[0] // 4, 1)
    out: List[Pathology] = []
    idxs = np.arange(0, ev.shape[0], window)  # partial tail window dropped
    if idxs.shape[0] < 2:
        return out
    rates = np.diff(ev[idxs], axis=0).astype(np.float64)  # events per window
    for t in range(T):
        r_t = rates[:, t]
        if active is not None:
            a = np.asarray(active[w, t], bool)
            resident = np.array([a[idxs[j]:idxs[j + 1]].all()
                                 for j in range(len(idxs) - 1)])
            if not resident.any():
                continue
            r_t = r_t[resident]
        bad = float((r_t > rate_threshold).mean())
        if bad >= frac_threshold:
            out.append(Pathology(
                "chronic_thrashing", t, severity=bad / frac_threshold,
                evidence={"mean_rate": float(r_t.mean()),
                          "bad_window_frac": bad,
                          "rate_threshold": rate_threshold}))
    return out


def detect_protection_violation(fast_usage: np.ndarray,
                                slow_usage: np.ndarray,
                                lower_protection: Sequence[int],
                                attempted: Optional[np.ndarray] = None,
                                demotions: Optional[np.ndarray] = None,
                                tolerance: float = PROT_TOLERANCE,
                                frac_threshold: float = PROT_FRAC_THRESHOLD,
                                active: Optional[np.ndarray] = None
                                ) -> List[Pathology]:
    """fast/slow_usage: [ticks, T]. A tenant violates its lower protection
    when its total footprint covers the protection but its fast-tier share
    sits below protection*(1-tolerance) — for >= ``frac_threshold`` of the
    steady window. Tenants that simply don't demand that much are exempt;
    when ``attempted``/``demotions`` [ticks, T] are given, ticks where the
    tenant neither sought promotion nor was demoted don't count either (a
    cold tenant sitting in the slow tier by its own access pattern is not a
    policy violation). With a churn roster (``active`` [ticks, T]), tenants
    that departed mid-window are skipped and non-resident ticks never count
    as violations."""
    ticks, T = fast_usage.shape
    w = _steady(ticks)
    prot = np.asarray(lower_protection, np.float64)
    out: List[Pathology] = []
    for t in range(T):
        if t >= prot.shape[0] or prot[t] <= 0:
            continue
        if not _tenant_in_window(active, w, t):
            continue
        demand = fast_usage[w, t] + slow_usage[w, t] >= prot[t]
        held_below = fast_usage[w, t] < prot[t] * (1 - tolerance)
        viol = demand & held_below
        if active is not None:
            viol &= np.asarray(active[w, t], bool)
        if attempted is not None or demotions is not None:
            wants = np.zeros(viol.shape, bool)
            if attempted is not None:
                wants |= attempted[w, t] > 0
            if demotions is not None:
                wants |= demotions[w, t] > 0
            viol &= wants
        frac = float(viol.mean())
        if frac >= frac_threshold:
            out.append(Pathology(
                "protection_violation", t, severity=frac / frac_threshold,
                evidence={"violation_frac": frac,
                          "mean_fast": float(fast_usage[w, t].mean()),
                          "protection": float(prot[t])}))
    return out


def detect_noisy_neighbor(promotions: np.ndarray, demotions: np.ndarray,
                          latency: np.ndarray,
                          dominance_threshold: float = NOISY_DOMINANCE,
                          degrade_threshold: float = NOISY_DEGRADE
                          ) -> List[Pathology]:
    """[ticks, T] each. Flags a tenant whose share of total migration traffic
    exceeds ``dominance_threshold`` over the steady window while at least one
    *other* tenant's steady latency exceeds its own early-run baseline by
    ``degrade_threshold``x — migrations stall everyone (§III-F)."""
    ticks, T = promotions.shape
    if T < 2:
        return []
    w = _steady(ticks)
    base_w = slice(0, max(ticks // 4, 1))
    mig = (promotions[w] + demotions[w]).sum(axis=0).astype(np.float64)  # [T]
    total = mig.sum()
    out: List[Pathology] = []
    if total <= 0:
        return out
    lat_now = latency[w].mean(axis=0)
    lat_base = np.maximum(latency[base_w].mean(axis=0), 1e-9)
    degrade = lat_now / lat_base
    for t in range(T):
        share = mig[t] / total
        others = np.delete(degrade, t)
        worst = float(others.max()) if others.size else 0.0
        if share > dominance_threshold and worst > degrade_threshold:
            out.append(Pathology(
                "noisy_neighbor", t,
                severity=(share / dominance_threshold)
                * (worst / degrade_threshold),
                evidence={"migration_share": float(share),
                          "worst_neighbor_degrade": worst}))
    return out


def detect_promotion_stall(attempted: np.ndarray, promotions: np.ndarray,
                           min_attempts_per_tick: float = STALL_MIN_ATTEMPTS,
                           success_threshold: float = STALL_SUCCESS,
                           active: Optional[np.ndarray] = None
                           ) -> List[Pathology]:
    """[ticks, T] per-tick attempts vs successes. Flags tenants with sustained
    promotion demand in the steady window whose success ratio is ~zero. A
    tenant that departed mid-window (``active`` roster) is skipped — demand
    that vanished with the tenant is churn, not a stalled promoter."""
    ticks, T = attempted.shape
    w = _steady(ticks)
    out: List[Pathology] = []
    for t in range(T):
        if not _tenant_in_window(active, w, t):
            continue
        att = float(attempted[w, t].sum())
        n = attempted[w, t].shape[0]
        if att < min_attempts_per_tick * n:
            continue
        ratio = float(promotions[w, t].sum()) / max(att, 1.0)
        if ratio < success_threshold:
            out.append(Pathology(
                "promotion_stall", t,
                severity=success_threshold / max(ratio, 1e-9),
                evidence={"attempts_per_tick": att / n,
                          "success_ratio": ratio}))
    return out


def detect_all(fast_usage: np.ndarray, slow_usage: np.ndarray,
               promotions: np.ndarray, demotions: np.ndarray,
               latency: np.ndarray, thrash_events: np.ndarray,
               attempted: Optional[np.ndarray] = None,
               lower_protection: Sequence[int] = (),
               thrash_rate_threshold: float = THRASH_RATE_THRESHOLD,
               active: Optional[np.ndarray] = None) -> List[Pathology]:
    """Run every detector over one host's collected telemetry. ``active``
    ([ticks, T] bool, optional) is the churn roster. Current-state
    pathologies (protection violation, promotion stall) skip tenants that
    departed mid-observation-window instead of misreading the truncated
    tail; historical pathologies (chronic thrashing — judged over resident
    windows — and noisy neighbor) still report tenants that have since
    departed."""
    found = detect_chronic_thrashing(
        thrash_events, rate_threshold=thrash_rate_threshold, active=active)
    if len(lower_protection):
        found += detect_protection_violation(fast_usage, slow_usage,
                                             lower_protection,
                                             attempted=attempted,
                                             demotions=demotions,
                                             active=active)
    found += detect_noisy_neighbor(promotions, demotions, latency)
    if attempted is not None:
        found += detect_promotion_stall(attempted, promotions, active=active)
    return found


def count_by_kind(pathologies: Sequence[Pathology]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for p in pathologies:
        out[p.kind] = out.get(p.kind, 0) + 1
    return out
