"""Streaming pathology detection: the offline detectors of
``obs/pathology.py`` as windowed state machines folded into the tick
(torch port of ``repro/obs/streaming.py``).

A ``DetectorState`` of [T]-shaped counters rides in ``TierState`` and is
updated once a tick (core/tick.py step 9b), so a fleet reports per-host
per-tenant pathology flags with O(H * T) memory at any horizon. The window
geometry is host-side constants (``DetectorSpec``), and the tick counter
``t`` is a host int, so the window tests are plain ``if``s.

Semantics (as in the reference): chronic thrashing, protection violation
and promotion stall accumulate the same integer counters the offline
detectors derive from traces, so ``streaming_pathologies`` agrees with
``detect_all`` on any horizon; noisy neighbor keeps running float32 sums.
Each tick also evaluates a running verdict from the counters so far,
feeding ``flag_ticks`` and ``first_flag`` (-1 = never).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device, to_host
from repro_torch.numerics import f32
from repro_torch.obs import pathology as PA
from repro_torch.obs.pathology import Pathology

# fixed kind order of the trailing axis of flag_ticks / first_flag
KINDS = ("chronic_thrashing", "protection_violation", "noisy_neighbor",
         "promotion_stall")
N_KINDS = len(KINDS)


@dataclass(frozen=True)
class DetectorSpec:
    """Host-side window geometry and thresholds, all Python constants."""
    horizon: int                 # ticks the run will last
    n_tenants: int
    protection: Tuple[float, ...]   # [T] lower protection (pages; 0 = none)
    steady_start: int            # first steady tick (offline _steady)
    window: int                  # thrash window width, post-adjustment
    base_ticks: int              # noisy-neighbor baseline = ticks < this
    thrash_rate_threshold: float = PA.THRASH_RATE_THRESHOLD
    thrash_frac_threshold: float = PA.THRASH_FRAC_THRESHOLD
    prot_tolerance: float = PA.PROT_TOLERANCE
    prot_frac_threshold: float = PA.PROT_FRAC_THRESHOLD
    noisy_dominance: float = PA.NOISY_DOMINANCE
    noisy_degrade: float = PA.NOISY_DEGRADE
    stall_min_attempts: float = PA.STALL_MIN_ATTEMPTS
    stall_success: float = PA.STALL_SUCCESS
    resident_min_frac: float = PA.RESIDENT_MIN_FRAC

    @property
    def n_steady(self) -> int:
        return self.horizon - self.steady_start


def make_detector(horizon: int, n_tenants: int,
                  lower_protection: Sequence[float] = (),
                  *, steady_frac: float = PA.STEADY_FRAC,
                  window: int = PA.THRASH_WINDOW,
                  **thresholds) -> DetectorSpec:
    """The window geometry exactly as the offline detectors derive it:
    steady window = last ``steady_frac`` of the run, thrash window shrunk to
    ``max(steady_len // 4, 1)`` when the steady half can't fit two full
    windows, noisy baseline = first quarter of the run."""
    s0 = int(horizon * (1 - steady_frac))        # pathology._steady
    n_steady = horizon - s0
    if n_steady < 2 * window:                    # detect_chronic_thrashing
        window = max(n_steady // 4, 1)
    prot = [0.0] * n_tenants
    for i, v in enumerate(lower_protection[:n_tenants]):
        prot[i] = float(v)
    return DetectorSpec(
        horizon=horizon, n_tenants=n_tenants, protection=tuple(prot),
        steady_start=s0, window=window,
        base_ticks=max(horizon // 4, 1),         # detect_noisy_neighbor
        **thresholds)


class DetectorSignals(NamedTuple):
    """One tick's telemetry, all [T], produced in the tick after the perf
    model."""
    active: torch.Tensor        # bool  tenant resident this tick
    thrash_new: torch.Tensor    # int32 thrash events this tick
    fast_usage: torch.Tensor    # int32 fast-tier pages
    slow_usage: torch.Tensor    # int32 slow-tier pages
    attempted: torch.Tensor     # int32 promotion candidates
    promotions: torch.Tensor    # int32
    demotions: torch.Tensor     # int32
    latency: torch.Tensor       # f32


class DetectorState(NamedTuple):
    """Tick-carried detector memory, all [T] unless noted."""
    # chronic thrashing: tumbling windows over the steady half
    win_events: torch.Tensor        # int32 thrash events in the open window
    win_resident: torch.Tensor      # bool  resident every tick of it
    windows_resident: torch.Tensor  # int32 closed fully-resident windows
    windows_bad: torch.Tensor       # int32 ... of those, over the threshold
    events_resident: torch.Tensor   # int32 events inside resident windows
    # protection violation
    viol_ticks: torch.Tensor        # int32 violating steady ticks
    fast_sum: torch.Tensor          # f32   steady fast_usage sum
    # promotion stall
    att_steady: torch.Tensor        # int32 steady promotion candidates
    promo_steady: torch.Tensor      # int32 steady promotions
    # noisy neighbor
    mig_steady: torch.Tensor        # int32 steady promotions + demotions
    lat_base_sum: torch.Tensor      # f32   latency over the baseline window
    lat_steady_sum: torch.Tensor    # f32   latency over the steady window
    # shared roster gate
    active_steady: torch.Tensor     # int32 resident steady ticks
    active_last: torch.Tensor       # bool  resident at last steady tick
    # online flags
    flag_ticks: torch.Tensor        # [T, N_KINDS] int32 ticks a flag held
    first_flag: torch.Tensor        # [T, N_KINDS] int32 first such tick, -1


def init_detector(spec: DetectorSpec, device="cuda") -> DetectorState:
    device = resolve_device(device)
    T = spec.n_tenants

    def z():
        return torch.zeros((T,), dtype=torch.int32, device=device)

    def f():
        return torch.zeros((T,), dtype=torch.float32, device=device)

    return DetectorState(
        win_events=z(),
        win_resident=torch.ones((T,), dtype=torch.bool, device=device),
        windows_resident=z(), windows_bad=z(), events_resident=z(),
        viol_ticks=z(), fast_sum=f(), att_steady=z(), promo_steady=z(),
        mig_steady=z(), lat_base_sum=f(), lat_steady_sum=f(),
        active_steady=z(),
        active_last=torch.zeros((T,), dtype=torch.bool, device=device),
        flag_ticks=torch.zeros((T, N_KINDS), dtype=torch.int32,
                               device=device),
        first_flag=torch.full((T, N_KINDS), -1, dtype=torch.int32,
                              device=device))


def update_detector(spec: DetectorSpec, det: DetectorState,
                    sig: DetectorSignals, t: int) -> DetectorState:
    """Fold tick ``t`` (a host int). The offline trace math:

    * window j of chronic thrashing covers steady ticks
      ``[s0 + j*W, s0 + (j+1)*W)``; its event count is the cumulative diff,
      so events at a boundary tick belong to the window that just closed
      and events at ``s0`` itself to none;
    * residency of window j = active on every tick it covers;
    * protection / stall / noisy counters are plain steady-window sums.

    Float thresholds are scaled in float32, as the reference's weak-typed
    scalars are."""
    i32 = torch.int32
    s0, W = spec.steady_start, spec.window
    in_steady = t >= s0
    past_s0 = t > s0
    active = sig.active

    # ---- chronic thrashing: tumbling windows -----------------------------
    if in_steady and past_s0:
        win_events = det.win_events + sig.thrash_new.to(i32)
    else:
        win_events = torch.zeros_like(det.win_events)
    boundary = in_steady and (t - s0) % W == 0
    windows_resident = det.windows_resident
    windows_bad = det.windows_bad
    events_resident = det.events_resident
    if boundary and past_s0:               # a window just closed
        bad = win_events.to(torch.float32) > f32(spec.thrash_rate_threshold)
        res_ok = det.win_resident          # covers the closed window's ticks
        windows_resident = windows_resident + res_ok.to(i32)
        windows_bad = windows_bad + (res_ok & bad).to(i32)
        events_resident = events_resident + torch.where(res_ok, win_events,
                                                        0)
        win_events = torch.zeros_like(win_events)
    # a boundary tick opens window j: its residency starts from this tick
    if boundary:
        win_resident = active
    elif in_steady:
        win_resident = det.win_resident & active
    else:
        win_resident = det.win_resident

    # ---- protection violation --------------------------------------------
    prot = _protection(spec, active.device)
    fu = sig.fast_usage.to(torch.float32)
    su = sig.slow_usage.to(torch.float32)
    viol = ((prot > 0)
            & (fu + su >= prot)
            & (fu < prot * f32(1.0 - spec.prot_tolerance))
            & active
            & ((sig.attempted > 0) | (sig.demotions > 0)))
    viol_ticks = det.viol_ticks
    fast_sum = det.fast_sum
    att_steady, promo_steady = det.att_steady, det.promo_steady
    active_steady, active_last = det.active_steady, det.active_last
    mig_steady = det.mig_steady
    lat = sig.latency.to(torch.float32)
    if in_steady:
        viol_ticks = viol_ticks + viol.to(i32)
        fast_sum = fast_sum + fu
        # ---- promotion stall + shared roster gate ------------------------
        att_steady = att_steady + sig.attempted.to(i32)
        promo_steady = promo_steady + sig.promotions.to(i32)
        active_steady = active_steady + active.to(i32)
        active_last = active
        # ---- noisy neighbor ----------------------------------------------
        mig_steady = mig_steady + (sig.promotions + sig.demotions).to(i32)
    lat_base_sum = (det.lat_base_sum + lat if t < spec.base_ticks
                    else det.lat_base_sum)
    lat_steady_sum = (det.lat_steady_sum + lat if in_steady
                      else det.lat_steady_sum)

    # ---- running verdicts (online-only flag counters) --------------------
    dev = active.device
    steady_so_far = float(max(t - s0 + 1, 1))
    n_res = windows_resident.to(torch.float32)
    f_thrash = (windows_resident >= 1) & (
        windows_bad.to(torch.float32)
        >= f32(spec.thrash_frac_threshold) * n_res)
    gate = active & (active_steady.to(torch.float32)
                     >= _scaled(spec.resident_min_frac, steady_so_far))
    f_prot = gate & (prot > 0) & (
        viol_ticks.to(torch.float32)
        >= _scaled(spec.prot_frac_threshold, steady_so_far))
    attf = att_steady.to(torch.float32)
    ratio = promo_steady.to(torch.float32) / torch.clamp(attf, min=1.0)
    f_stall = (gate
               & (attf >= _scaled(spec.stall_min_attempts, steady_so_far))
               & (ratio < f32(spec.stall_success)))
    if not in_steady:
        f_prot = torch.zeros_like(f_prot)
        f_stall = torch.zeros_like(f_stall)
    f_noisy = torch.zeros((spec.n_tenants,), dtype=torch.bool, device=dev)
    if spec.n_tenants >= 2 and in_steady:
        total_mig = mig_steady.sum(dtype=i32).to(torch.float32)
        share = mig_steady.to(torch.float32) / torch.clamp(total_mig, min=1.0)
        n_base_done = _divisor(max(min(t + 1, spec.base_ticks), 1), dev)
        lat_base = torch.clamp(lat_base_sum / n_base_done, min=f32(1e-9))
        degrade = (lat_steady_sum / _divisor(steady_so_far, dev)) / lat_base
        top2 = torch.topk(degrade, 2).values      # values only: ties moot
        worst_other = torch.where(degrade >= top2[0], top2[1], top2[0])
        f_noisy = ((total_mig > 0)
                   & (share > f32(spec.noisy_dominance))
                   & (worst_other > f32(spec.noisy_degrade)))

    flags = torch.stack([f_thrash, f_prot, f_noisy, f_stall], dim=-1)
    flag_ticks = det.flag_ticks + flags.to(i32)
    first_flag = torch.where(flags & (det.first_flag < 0), t, det.first_flag)

    return DetectorState(
        win_events=win_events, win_resident=win_resident,
        windows_resident=windows_resident, windows_bad=windows_bad,
        events_resident=events_resident,
        viol_ticks=viol_ticks, fast_sum=fast_sum,
        att_steady=att_steady, promo_steady=promo_steady,
        mig_steady=mig_steady, lat_base_sum=lat_base_sum,
        lat_steady_sum=lat_steady_sum,
        active_steady=active_steady, active_last=active_last,
        flag_ticks=flag_ticks, first_flag=first_flag)


_PROT: dict = {}


def _protection(spec: DetectorSpec, device: torch.device) -> torch.Tensor:
    """The spec's [T] float32 protections on ``device``, copied there once
    (a copy from pageable host memory each tick would wait for the
    device)."""
    key = (spec.protection, str(device))
    if key not in _PROT:
        _PROT[key] = torch.tensor(spec.protection, dtype=torch.float32,
                                  device=device)
    return _PROT[key]


def _divisor(n: float, device) -> torch.Tensor:
    """A float32 divisor on the device: a Python scalar divisor on a CUDA
    tensor becomes a multiply by its reciprocal, which can round apart from
    the reference's true division."""
    return torch.full((), n, dtype=torch.float32, device=device)


def _scaled(frac: float, n: float) -> float:
    """``frac * n`` rounded as a float32 product (both float32 first)."""
    return float(np.float32(frac) * np.float32(n))


def run_detector(spec: DetectorSpec, *, active, thrash_new, fast_usage,
                 slow_usage, attempted, promotions, demotions,
                 latency, device="cuda") -> DetectorState:
    """Replay host-side [ticks, T] telemetry through the streaming update,
    one tick per step of a Python loop: fed the arrays the offline
    detectors consume, ``streaming_pathologies`` must agree with
    ``detect_all``."""
    device = resolve_device(device)

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    xs = (dev(active, torch.bool), dev(thrash_new, torch.int32),
          dev(fast_usage, torch.int32), dev(slow_usage, torch.int32),
          dev(attempted, torch.int32), dev(promotions, torch.int32),
          dev(demotions, torch.int32), dev(latency, torch.float32))
    ticks = xs[0].shape[0]
    assert ticks == spec.horizon, (ticks, spec.horizon)
    det = init_detector(spec, device)
    for t in range(ticks):
        det = update_detector(spec, det,
                              DetectorSignals(*(x[t] for x in xs)), t)
    return det


def streaming_pathologies(spec: DetectorSpec,
                          det: DetectorState) -> List[Pathology]:
    """End-of-run decisions from the final counters: the thresholds, gates
    and severity/evidence formulas of ``pathology.detect_all`` on O(T)
    streamed state."""
    d = {f: to_host(getattr(det, f)) for f in det._fields}
    if d["flag_ticks"].ndim == 3:
        raise ValueError("got a batched DetectorState; index the host axis "
                         "first (state.host_slice(det, h))")
    T = spec.n_tenants
    n_steady = spec.n_steady
    out: List[Pathology] = []
    if n_steady <= 0:
        return out

    for t in range(T):                       # chronic thrashing
        n_res = int(d["windows_resident"][t])
        if n_res < 1:
            continue
        bad_frac = float(d["windows_bad"][t]) / n_res
        if bad_frac >= spec.thrash_frac_threshold:
            out.append(Pathology(
                "chronic_thrashing", t,
                severity=bad_frac / spec.thrash_frac_threshold,
                evidence={"mean_rate": float(d["events_resident"][t]) / n_res,
                          "bad_window_frac": bad_frac,
                          "rate_threshold": spec.thrash_rate_threshold}))

    def in_window(t: int) -> bool:           # _tenant_in_window analogue
        return (bool(d["active_last"][t])
                and float(d["active_steady"][t]) / n_steady
                >= spec.resident_min_frac)

    if any(p > 0 for p in spec.protection):  # protection violation
        for t in range(T):
            if spec.protection[t] <= 0 or not in_window(t):
                continue
            frac = float(d["viol_ticks"][t]) / n_steady
            if frac >= spec.prot_frac_threshold:
                out.append(Pathology(
                    "protection_violation", t,
                    severity=frac / spec.prot_frac_threshold,
                    evidence={"violation_frac": frac,
                              "mean_fast": float(d["fast_sum"][t]) / n_steady,
                              "protection": spec.protection[t]}))

    if T >= 2:                               # noisy neighbor
        mig = d["mig_steady"].astype(np.float64)
        total = mig.sum()
        if total > 0:
            lat_now = d["lat_steady_sum"].astype(np.float64) / n_steady
            lat_base = np.maximum(
                d["lat_base_sum"].astype(np.float64) / spec.base_ticks, 1e-9)
            degrade = lat_now / lat_base
            for t in range(T):
                share = mig[t] / total
                others = np.delete(degrade, t)
                worst = float(others.max()) if others.size else 0.0
                if share > spec.noisy_dominance and worst > spec.noisy_degrade:
                    out.append(Pathology(
                        "noisy_neighbor", t,
                        severity=(share / spec.noisy_dominance)
                        * (worst / spec.noisy_degrade),
                        evidence={"migration_share": float(share),
                                  "worst_neighbor_degrade": worst}))

    for t in range(T):                       # promotion stall
        if not in_window(t):
            continue
        att = float(d["att_steady"][t])
        if att < spec.stall_min_attempts * n_steady:
            continue
        ratio = float(d["promo_steady"][t]) / max(att, 1.0)
        if ratio < spec.stall_success:
            out.append(Pathology(
                "promotion_stall", t,
                severity=spec.stall_success / max(ratio, 1e-9),
                evidence={"attempts_per_tick": att / n_steady,
                          "success_ratio": ratio}))
    return out


def flag_summary(det: DetectorState) -> dict:
    """Plain-numpy view of the online flag counters (a single host [T, K]
    or a stacked fleet [H, T, K] state)."""
    return {"flag_ticks": to_host(det.flag_ticks),
            "first_flag": to_host(det.first_flag),
            "kinds": KINDS}
