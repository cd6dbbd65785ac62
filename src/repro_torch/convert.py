"""State and weights carried between the reference and the port.

Every function reads a reference tree whose leaves were made numpy arrays
(by field or key name, so nothing of the reference is imported):

* ``state_from_numpy`` / ``state_to_numpy``: the tiering engine's
  ``TierState``;
* ``params_from_numpy``: the reference's parameter tree -> the port's
  ``DenseLM`` (names and layouts map one to one);
* ``cache_from_numpy`` / ``cache_to_numpy``: the serving path's
  ``TieredKVCache``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import Counters, ThrashTable, TierState
from repro_torch.device import resolve_device
from repro_torch.memtier.kvcache import TieredKVCache
from repro_torch.models.transformer import DenseLM
from repro_torch.obs.stats import TierStats
from repro_torch.obs.trace import MigrationRing


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def _sub(tree, cls, device):
    return cls(*(_t(getattr(tree, f), device) for f in cls._fields))


def state_from_numpy(tree, device="cuda") -> TierState:
    """The port's TierState from a reference TierState with numpy leaves.
    Optional subtrees (detectors, attribution, hotness state) must be None."""
    device = resolve_device(device)
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


# ------------------------------------------------------------- serving ----
def params_from_numpy(tree, cfg, device="cuda"):
    """The port's ``DenseLM`` from a reference parameter tree whose leaves
    were made numpy arrays (``{"embed": {...}, "layers": {...}}``, stacked
    layer axis). Names and layouts map one to one; every leaf must match the
    model's shape."""
    model = DenseLM(cfg, seed=None, device=device)
    params = dict(model.named_parameters())
    seen = set()

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + ".")
                continue
            if name not in params:
                raise KeyError(f"reference parameter {name!r} has no "
                               "counterpart in the port's model")
            p = params[name]
            src = torch.as_tensor(np.asarray(v, np.float32))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(src.to(p.dtype))
            seen.add(name)

    walk(tree, "")
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"reference tree lacks {missing}")
    return model


def _tensor_from_numpy(x, device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16, which torch cannot read) -> tensor."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.view(np.uint16).astype(np.int16),
                               device=device).view(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def cache_from_numpy(tree, device="cuda"):
    """The port's ``TieredKVCache`` from a reference ``TieredKVCache`` whose
    leaves were made numpy arrays (read by field name)."""
    device = resolve_device(device)
    subtrees = {"counters": Counters, "table": ThrashTable,
                "stats": TierStats, "ring": MigrationRing}
    out = {}
    for f in TieredKVCache._fields:
        v = getattr(tree, f)
        if f == "t":
            out[f] = int(np.asarray(v))
        elif f in subtrees:
            cls = subtrees[f]
            out[f] = cls(*(_tensor_from_numpy(getattr(v, g), device)
                           for g in cls._fields))
        else:
            out[f] = _tensor_from_numpy(v, device)
    return TieredKVCache(**out)


def cache_to_numpy(cache) -> dict:
    """Nested dict of numpy arrays keyed by the reference's field names (``t``
    as np.int32; bf16 pools widen exactly to float32)."""
    def leaf(x):
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()

    out = {}
    for f in cache._fields:
        v = getattr(cache, f)
        if f == "t":
            out[f] = np.int32(v)
        elif hasattr(v, "_fields"):
            out[f] = {g: leaf(getattr(v, g)) for g in v._fields}
        else:
            out[f] = leaf(v)
    return out
