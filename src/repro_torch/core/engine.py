"""The static-ownership tiering engine: a thin adapter over the unified tick
core (core/tick.py) for fixed tenant rosters (torch port of
``repro/core/engine.py``).

Modes select the policy:

  equilibria — the paper (Eq.1 + Eq.2 + upper bound + thrash mitigation)
  tpp        — baseline Linux/TPP: watermark-driven *global-LRU* demotion,
               hint-fault-style *global* promotion, no fairness
  memtis     — MEMTIS-like: upper limit only (allocation-time enforcement)
  static     — tier fixed at allocation, no migration

``impl`` selects the selection core:

  "cuda"    — the kernel-backed strategy on the hand-written CUDA kernels
              (the default on a CUDA device; rejected on the CPU)
  "ref"     — the same strategy over the kernels' plain torch versions
              (the default on the CPU)
  "batched" — the plain mirror of the reference's jnp default path
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core.state import TierState, init_state
from repro_torch.core.tick import (MODES, TickOutput, make_tick_core,
                                   static_ownership)
from repro_torch.device import resolve_device

__all__ = ["MODES", "TickOutput", "make_tick", "run_engine",
           "resolve_device", "resolve_impl"]


def resolve_impl(impl: Optional[str], device: torch.device) -> str:
    """The selection-core impl for ``device``: "cuda" on a card, "ref" on
    the CPU unless given; "cuda" on the CPU raises. (``static_strategy``
    rejects names it does not know.)"""
    if impl is None:
        return "cuda" if device.type == "cuda" else "ref"
    if impl == "cuda" and device.type != "cuda":
        raise ValueError("impl='cuda' needs a CUDA device; use impl='ref' or "
                         "'batched' on the CPU")
    return impl


def make_tick(cfg: TieringConfig, owner: np.ndarray, mode: str = "equilibria",
              k_max: int = 256, impl: Optional[str] = None, device="cuda",
              detector=None, attrib=None, hotness=None):
    """Build the tick ``(state, (accesses [L], alive [L])) -> (state',
    TickOutput)``. owner: [L] int (static tenant of each page, contiguous)."""
    dev = resolve_device(device)
    impl = resolve_impl(impl, dev)
    provider = static_ownership(cfg, owner, k_max=k_max, impl=impl,
                                device=dev)
    return make_tick_core(cfg, provider, mode=mode, k_max=k_max,
                          detector=detector, attrib=attrib, hotness=hotness)


def stack_outputs(outs: list) -> TickOutput:
    """Per-tick outputs stacked along a leading tick axis."""
    return TickOutput(*(torch.stack(f) for f in zip(*outs)))


def run_engine(cfg: TieringConfig, owner: np.ndarray, accesses: np.ndarray,
               alive: np.ndarray, mode: str = "equilibria",
               k_max: int = 256, impl: Optional[str] = None, device="cuda",
               detector=None, attrib=None, hotness=None
               ) -> Tuple[TierState, TickOutput]:
    """Run the full trace, one tick per step of a Python loop.
    accesses/alive: [ticks, L]. Returns the final state and the per-tick
    outputs stacked along a leading tick axis."""
    dev = resolve_device(device)
    tick = make_tick(cfg, owner, mode, k_max, impl=impl, device=dev,
                     detector=detector, attrib=attrib, hotness=hotness)
    state = init_state(cfg, owner.shape[0], owner=owner, device=dev)
    acc = torch.as_tensor(np.asarray(accesses, np.float32), device=dev)
    alv = torch.as_tensor(np.asarray(alive, bool), device=dev)
    outs = []
    for i in range(acc.shape[0]):
        state, out = tick(state, (acc[i], alv[i]))
        outs.append(out)
    return state, stack_outputs(outs)
