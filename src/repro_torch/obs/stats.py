"""Per-tenant tiering statistics — the cgroup ``tiering_stat`` analogue of
paper §IV-C, collected inside the tick (torch port of ``repro/obs/stats.py``).

``TierStats`` rides in the engine state and is updated with tensor
scatter/adds: log-bucketed fast-tier residency histograms, attempt-vs-success
migration counters, contention / watermark / throttle state occupancy, and
EWMA-windowed thrash and migration rates.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.numerics import fused_mul_add

N_RESID_BUCKETS = 16         # log2 buckets: [0,2), [2,4), [4,8), ... ticks
WINDOW_DECAY = 0.9           # EWMA decay for windowed rates (per tick)


class TierStats(NamedTuple):
    """Per-tenant tiering_stat metrics. All [T]-leading unless noted."""
    # distribution: fast-tier residency time at demotion/free, log2 buckets
    resid_hist: torch.Tensor       # [T, N_RESID_BUCKETS] int32
    # attempt vs success (cumulative)
    promo_attempts: torch.Tensor   # [T] int32 candidates offered to promoter
    promo_success: torch.Tensor    # [T] int32 pages actually promoted
    demo_attempts: torch.Tensor    # [T] int32 demotion quota issued
    demo_success: torch.Tensor     # [T] int32 pages actually demoted
    # state occupancy (ticks spent in each condition, cumulative)
    contended_ticks: torch.Tensor  # [T] int32 local memory contended
    throttled_ticks: torch.Tensor  # [T] int32 promotion-throttled (Eq.2)
    below_protection_ticks: torch.Tensor  # [T] int32 held under lower protection
    # windowed rates (EWMA over ticks; rate ~ events per 1/(1-decay) ticks)
    thrash_rate: torch.Tensor      # [T] f32
    promo_rate: torch.Tensor       # [T] f32
    demo_rate: torch.Tensor        # [T] f32
    # aux: tick each fast-resident page entered the fast tier (-1 = not fast)
    fast_since: torch.Tensor       # [L] int32
    ticks: torch.Tensor            # 0-d int32 ticks observed


def init_stats(n_tenants: int, fast_since_shape,
               n_buckets: int = N_RESID_BUCKETS, device="cuda") -> TierStats:
    device = resolve_device(device)

    def z():
        return torch.zeros((n_tenants,), dtype=torch.int32, device=device)

    def f():
        return torch.zeros((n_tenants,), dtype=torch.float32, device=device)
    return TierStats(
        resid_hist=torch.zeros((n_tenants, n_buckets), dtype=torch.int32,
                               device=device),
        promo_attempts=z(), promo_success=z(), demo_attempts=z(),
        demo_success=z(), contended_ticks=z(), throttled_ticks=z(),
        below_protection_ticks=z(),
        thrash_rate=f(), promo_rate=f(), demo_rate=f(),
        fast_since=torch.full(tuple(fast_since_shape), -1, dtype=torch.int32,
                              device=device),
        ticks=torch.zeros((), dtype=torch.int32, device=device))


def residency_bucket(age: torch.Tensor, n_buckets: int = N_RESID_BUCKETS
                     ) -> torch.Tensor:
    """log2 bucket of a residency age (ticks): 0/1 -> 0, 2-3 -> 1, 4-7 -> 2,
    ...; clipped to the last bucket. Exact in integers: the reference's f32
    ``floor(log2(age))`` is one low at a few powers of two (8192, 32768)."""
    a = torch.clamp(age, min=1).to(torch.int64)
    b = torch.floor(torch.log2(a.to(torch.float64))).to(torch.int64)
    b = torch.clamp(b, 0, 62)
    b = b - (torch.bitwise_left_shift(torch.ones_like(b), b) > a).to(torch.int64)
    b = b + (torch.bitwise_left_shift(torch.ones_like(b), b + 1) <= a
             ).to(torch.int64)
    return torch.clamp(b, 0, n_buckets - 1).to(torch.int32)


def bucket_edges(n_buckets: int = N_RESID_BUCKETS) -> np.ndarray:
    """Host-side: inclusive lower edge of each bucket, in ticks."""
    return np.concatenate([[0], 2 ** np.arange(1, n_buckets)])


def below_protection(fast_usage: torch.Tensor, slow_usage: torch.Tensor,
                     lower_protection: torch.Tensor) -> torch.Tensor:
    """[T] bool: tenant's footprint covers its lower protection but its
    fast-tier share sits below it — the §IV-B invariant under strain."""
    return ((lower_protection > 0)
            & (fast_usage < lower_protection)
            & (fast_usage + slow_usage >= lower_protection))


def record_fast_entries(stats: TierStats, entered: torch.Tensor,
                        t: int) -> TierStats:
    """Stamp the entry tick of pages that just became fast-resident."""
    return stats._replace(
        fast_since=torch.where(entered, t, stats.fast_since))


def _hist_add(hist: torch.Tensor, owners: torch.Tensor, bucket: torch.Tensor,
              exited: torch.Tensor) -> torch.Tensor:
    nb = hist.shape[1]
    flat = owners.reshape(-1).to(torch.int64) * nb + bucket.reshape(-1)
    return hist.reshape(-1).index_add(
        0, flat, exited.reshape(-1).to(torch.int32)).reshape(hist.shape)


def record_fast_exits(stats: TierStats, exited: torch.Tensor,
                      owners: torch.Tensor, t: int) -> TierStats:
    """Bucket residency time for pages leaving the fast tier (demotion or
    free) into the per-tenant histogram, and clear their entry stamps.
    exited/owners: same shape as ``stats.fast_since``."""
    exited = exited & (stats.fast_since >= 0)
    bucket = residency_bucket(t - stats.fast_since, stats.resid_hist.shape[1])
    return stats._replace(
        resid_hist=_hist_add(stats.resid_hist, owners, bucket, exited),
        fast_since=torch.where(exited, -1, stats.fast_since))


def record_fast_exits_at(stats: TierStats, pages: torch.Tensor,
                         exited: torch.Tensor, owners: torch.Tensor,
                         t: int) -> TierStats:
    """Compact variant of ``record_fast_exits``: ``pages`` indexes into the
    1-D ``fast_since`` (sentinel ``L`` lanes allowed: their gather is
    clamped, as in the reference, and they are never ``exited``)."""
    L = stats.fast_since.shape[0]
    fs = stats.fast_since[torch.clamp(pages, max=L - 1)]
    exited = exited & (fs >= 0)
    bucket = residency_bucket(t - fs, stats.resid_hist.shape[1])
    clear = torch.where(exited, pages, L).reshape(-1)   # L = dump slot
    fs_buf = torch.cat([stats.fast_since, stats.fast_since.new_zeros(1)])
    fs_buf.index_fill_(0, clear.to(torch.int64), -1)
    return stats._replace(
        resid_hist=_hist_add(stats.resid_hist, owners, bucket, exited),
        fast_since=fs_buf[:L])


def update_tick(stats: TierStats, *,
                promo_attempts: torch.Tensor, promo_success: torch.Tensor,
                demo_attempts: torch.Tensor, demo_success: torch.Tensor,
                thrash_new: torch.Tensor,
                contended: torch.Tensor,
                throttled: Optional[torch.Tensor] = None,
                below_protection: Optional[torch.Tensor] = None,
                decay: float = WINDOW_DECAY) -> TierStats:
    """Fold one tick's telemetry into the stats. All [T] except ``contended``
    (0-d bool, broadcast to every tenant)."""
    T = stats.promo_attempts.shape[0]
    c = contended.to(torch.int32).expand(T)
    thr = (torch.zeros_like(stats.throttled_ticks) if throttled is None
           else throttled.to(torch.int32))
    bp = (torch.zeros_like(stats.below_protection_ticks)
          if below_protection is None else below_protection.to(torch.int32))
    return stats._replace(
        promo_attempts=stats.promo_attempts + promo_attempts,
        promo_success=stats.promo_success + promo_success,
        demo_attempts=stats.demo_attempts + demo_attempts,
        demo_success=stats.demo_success + demo_success,
        contended_ticks=stats.contended_ticks + c,
        throttled_ticks=stats.throttled_ticks + thr,
        below_protection_ticks=stats.below_protection_ticks + bp,
        thrash_rate=fused_mul_add(decay, stats.thrash_rate,
                                  thrash_new.to(torch.float32)),
        promo_rate=fused_mul_add(decay, stats.promo_rate,
                                 promo_success.to(torch.float32)),
        demo_rate=fused_mul_add(decay, stats.demo_rate,
                                demo_success.to(torch.float32)),
        ticks=stats.ticks + 1)


# One histogram-percentile spec, two implementations (torch for state-side
# exports, numpy for host-side decoding). For a [T, NB] histogram with
# inclusive cumulative mass ``cum`` and ``total = cum[:, -1]``, the
# q-percentile is the LOWER EDGE of the first bucket where
# ``cum >= q * total``; an empty histogram gives 0.0.
def hist_percentile_j(hist: torch.Tensor, q: float) -> torch.Tensor:
    """Tensor per-tenant percentile (bucket lower edge) of residency."""
    edges = torch.as_tensor(bucket_edges(hist.shape[1]), dtype=torch.float32,
                            device=hist.device)
    cum = torch.cumsum(hist, dim=1, dtype=torch.int32)
    total = cum[:, -1:]
    hit = cum.to(torch.float32) >= q * total.to(torch.float32)
    idx = torch.argmax(hit.to(torch.int32), dim=1)   # first True
    return torch.where(total[:, 0] > 0, edges[idx], 0.0)


def stats_export(stats: TierStats) -> dict:
    """Derived tiering_stat metrics as tensors (the state-side counterpart
    of ``stats_summary``)."""
    ticks = torch.clamp(stats.ticks, min=1).to(torch.float32)
    att_p = stats.promo_attempts.to(torch.float32)
    att_d = stats.demo_attempts.to(torch.float32)
    return {
        "resid_p50": hist_percentile_j(stats.resid_hist, 0.50),
        "resid_p99": hist_percentile_j(stats.resid_hist, 0.99),
        "promo_success_ratio": torch.where(
            att_p > 0, stats.promo_success / torch.clamp(att_p, min=1.0), 1.0),
        "demo_success_ratio": torch.where(
            att_d > 0, stats.demo_success / torch.clamp(att_d, min=1.0), 1.0),
        "contended_frac": stats.contended_ticks / ticks,
        "throttled_frac": stats.throttled_ticks / ticks,
        "below_protection_frac": stats.below_protection_ticks / ticks,
        "thrash_rate": stats.thrash_rate,
    }


# ------------------------------------------------------------ host side ----
def hist_percentile(hist: np.ndarray, q: float) -> np.ndarray:
    """Numpy twin of ``hist_percentile_j`` — same spec, decoded host-side
    and vectorized over tenants."""
    hist = np.asarray(hist)
    edges = bucket_edges(hist.shape[1]).astype(np.float64)
    cum = np.cumsum(hist, axis=1)
    total = cum[:, -1]
    idx = np.argmax(cum >= q * total[:, None], axis=1)
    return np.where(total > 0, edges[idx], 0.0)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def stats_summary(stats: TierStats) -> dict:
    """Decode a TierStats to plain numpy, with derived ratios the pathology
    detectors and reports consume."""
    h = _np(stats.resid_hist)
    att_p = _np(stats.promo_attempts).astype(np.float64)
    suc_p = _np(stats.promo_success).astype(np.float64)
    att_d = _np(stats.demo_attempts).astype(np.float64)
    suc_d = _np(stats.demo_success).astype(np.float64)
    ticks = max(int(stats.ticks), 1)
    return {
        "resid_hist": h,
        "resid_bucket_edges": bucket_edges(h.shape[1]),
        "resid_p50": hist_percentile(h, 0.50),
        "resid_p99": hist_percentile(h, 0.99),
        "promo_attempts": att_p.astype(np.int64),
        "promo_success": suc_p.astype(np.int64),
        "promo_success_ratio": np.where(att_p > 0, suc_p / np.maximum(att_p, 1), 1.0),
        "demo_attempts": att_d.astype(np.int64),
        "demo_success": suc_d.astype(np.int64),
        "demo_success_ratio": np.where(att_d > 0, suc_d / np.maximum(att_d, 1), 1.0),
        "contended_frac": _np(stats.contended_ticks) / ticks,
        "throttled_frac": _np(stats.throttled_ticks) / ticks,
        "below_protection_frac": _np(stats.below_protection_ticks) / ticks,
        "thrash_rate": _np(stats.thrash_rate),
        "promo_rate": _np(stats.promo_rate),
        "demo_rate": _np(stats.demo_rate),
        "ticks": ticks,
    }


def format_tier_stat(stat: dict, summary: dict, tenant: int) -> str:
    """One tenant's cgroup-file-style report line block (§IV-C)."""
    lines = []
    for key in ("local_usage_bytes", "cxl_usage_bytes", "pgpromote",
                "pgdemote", "pgpromote_attempted", "pgreclaim", "pgalloc",
                "thrash_events", "sync_demotions"):
        if key in stat:
            lines.append(f"  {key} {int(_np(stat[key])[tenant])}")
    lines.append(f"  promo_success_ratio "
                 f"{summary['promo_success_ratio'][tenant]:.3f}")
    lines.append(f"  resident_time_p50_ticks {summary['resid_p50'][tenant]:.0f}")
    lines.append(f"  resident_time_p99_ticks {summary['resid_p99'][tenant]:.0f}")
    lines.append(f"  thrash_rate_windowed {summary['thrash_rate'][tenant]:.2f}")
    lines.append(f"  contended_frac {summary['contended_frac'][tenant]:.3f}")
    lines.append(f"  throttled_frac {summary['throttled_frac'][tenant]:.3f}")
    lines.append(f"  below_protection_frac "
                 f"{summary['below_protection_frac'][tenant]:.3f}")
    return "\n".join(lines)
