"""Dynamic-ownership tiering engine: tenant lifecycle as tick inputs — a thin
adapter over the unified tick core (torch port of ``repro/core/churn.py``).

The dynamic ownership provider (``core.tick.dynamic_ownership``) makes
ownership state: ``TierState.owner`` ([L] int32, ``n_tenants`` = FREE
sentinel) is mutated every tick by a schedule

    want  [T]    int32 — target footprint of each tenant slot (0 = departed)
    rates [T, S] f32   — access rate of the tenant's k-th page (tenant-local
                         address space; S = max slot footprint)

so one tick function serves any churn schedule. Each tick the provider
reclaims (departure/shrink, coldest pages first), grants from the free pool
(``select.pool_grant``; lower slot ids win when the pool is
over-subscribed), resets reused slots' controller state, re-partitions the
policy over the active slots (``policy.repartition_policy``) and reads page
l's rate as ``rates[owner[l], rank(l)]``; then steps 2-9 are the same code
the static engine runs.

Conservation: every page has at most one owner, departed tenants own zero
pages, and ``fast + slow + free == L`` every tick.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core.engine import (MODES, TickOutput, resolve_impl,  # noqa: F401
                                     stack_outputs)
from repro_torch.core.state import TierState, init_state
from repro_torch.core.tick import dynamic_ownership, make_tick_core
from repro_torch.device import resolve_device

__all__ = ["ChurnSchedule", "churn_events", "make_churn_tick",
           "run_churn_engine", "MODES", "TickOutput"]


class ChurnSchedule(NamedTuple):
    """Host-side (numpy) lifecycle schedule for a churn run."""
    want: np.ndarray      # [ticks, T] int32 target footprints (0 = departed)
    rates: np.ndarray     # [ticks, T, S] f32 tenant-local access rates


def churn_events(want: np.ndarray) -> Tuple[int, int]:
    """(arrivals, departures) across a [ticks, T] schedule: transitions of
    the active mask, counting initially-active slots as arrivals."""
    active = np.asarray(want) > 0
    prev = np.concatenate([np.zeros((1, active.shape[1]), bool), active[:-1]])
    arrivals = int((active & ~prev).sum())
    departures = int((~active & prev).sum())
    return arrivals, departures


def make_churn_tick(cfg: TieringConfig, n_pages: int, mode: str = "equilibria",
                    k_max: int = 256, detector=None, attrib=None,
                    hotness=None, impl: Optional[str] = None, device="cuda"):
    """Build the dynamic-ownership tick ``(state, (rates [T, S] f32, want [T]
    int32)) -> (state', TickOutput)``.

    n_pages: size of the physical page pool (fast + slow capacity).
    ``hotness``: a hotness-provider spec (core/hotness.py); stateful
    providers pair with ``init_state(..., hotness=...)``. ``impl``:
    "batched" (the composite-sort selection), "ref" or "cuda" (the
    segmented top-k over a rowspace built each call, on its plain version
    or on the CUDA kernel); the default is "cuda" on a card, "ref" on the
    CPU."""
    dev = resolve_device(device)
    impl = resolve_impl(impl, dev)
    provider = dynamic_ownership(cfg, n_pages, k_max=k_max, impl=impl,
                                 device=dev)
    return make_tick_core(cfg, provider, mode=mode, k_max=k_max,
                          detector=detector, attrib=attrib, hotness=hotness)


def run_churn_engine(cfg: TieringConfig, schedule: ChurnSchedule,
                     mode: str = "equilibria", k_max: int = 256,
                     n_pages: Optional[int] = None, detector=None,
                     attrib=None, hotness=None, impl: Optional[str] = None,
                     device="cuda") -> Tuple[TierState, TickOutput]:
    """Run a full churn schedule, one tick per step of a Python loop, from
    an all-free pool. The pool defaults to the configured capacity
    ``n_fast_pages + n_slow_pages``; grants beyond it are truncated in slot
    order (admission control under memory pressure). The schedule goes to
    the device once. Returns the final state and the per-tick outputs
    stacked along a leading tick axis."""
    dev = resolve_device(device)
    L = n_pages if n_pages is not None else cfg.n_fast_pages + cfg.n_slow_pages
    tick = make_churn_tick(cfg, L, mode=mode, k_max=k_max, detector=detector,
                           attrib=attrib, hotness=hotness, impl=impl,
                           device=dev)
    state = init_state(cfg, L, owner=None, device=dev, hotness=hotness,
                       detector=detector, attrib=attrib)
    rates = torch.as_tensor(np.asarray(schedule.rates, np.float32),
                            device=dev)
    want = torch.as_tensor(np.asarray(schedule.want, np.int32), device=dev)
    outs = []
    for i in range(want.shape[0]):
        state, out = tick(state, (rates[i], want[i]))
        outs.append(out)
    return state, stack_outputs(outs)
