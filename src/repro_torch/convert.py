"""Engine state carried between the reference and the port.

This slice runs no model; its "parameters" are the engine state.
``state_from_numpy`` takes a reference ``TierState`` whose leaves were made
numpy arrays (read by field name, so nothing of the reference is imported)
and builds the port's ``TierState``; ``state_to_numpy`` is its inverse, a
nested dict of numpy arrays keyed the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import Counters, ThrashTable, TierState
from repro_torch.obs.stats import TierStats
from repro_torch.obs.trace import MigrationRing


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def _sub(tree, cls, device):
    return cls(*(_t(getattr(tree, f), device) for f in cls._fields))


def state_from_numpy(tree, device="cpu") -> TierState:
    """The port's TierState from a reference TierState with numpy leaves.
    Optional subtrees (detectors, attribution, hotness state) must be None."""
    for f in ("det", "attrib", "hotness"):
        if getattr(tree, f, None) is not None:
            raise NotImplementedError(f"state field {f!r} is not ported yet")
    top = {f: _t(getattr(tree, f), device)
           for f in ("tier", "hot", "last_access", "owner", "promo_scale",
                     "thrash_prev", "usage_prev", "freed_since", "steady",
                     "mitigated_prev")}
    return TierState(
        counters=_sub(tree.counters, Counters, device),
        table=_sub(tree.table, ThrashTable, device),
        stats=_sub(tree.stats, TierStats, device),
        ring=_sub(tree.ring, MigrationRing, device),
        t=int(np.asarray(tree.t)), **top)


def state_to_numpy(state: TierState) -> dict:
    """Nested dict of numpy arrays (and ``t`` as np.int32), keyed by the
    reference's field names."""
    def leaf(x):
        return x.cpu().numpy() if torch.is_tensor(x) else x

    out = {}
    for f in TierState._fields:
        v = getattr(state, f)
        if f == "t":
            out[f] = np.int32(v)
        elif hasattr(v, "_fields"):
            out[f] = {g: leaf(getattr(v, g)) for g in v._fields}
        else:
            out[f] = leaf(v)
    return out
