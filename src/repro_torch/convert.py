"""State and weights carried between the reference and the port.

Every function reads a reference tree whose leaves were made numpy arrays
(by field or key name, so nothing of the reference is imported):

* ``state_from_numpy`` / ``state_to_numpy``: the tiering engine's
  ``TierState``;
* ``params_from_numpy``: the reference's parameter tree -> the port's
  model of any family (names and layouts map one to one: the moe layers'
  router and [L, E, d, f] experts, the ssm LM's Mamba2 stack, the hybrid's
  ``shared`` block, the encdec's ``encoder``/``decoder`` stacks and
  ``enc_ln``, the vlm's ``units.self`` with its two stacked axes and
  ``units.cross`` with its scalar gates); ``params_to_numpy``, its
  inverse;
* ``opt_state_from_numpy`` / ``opt_state_to_numpy``: the optimizer's
  ``OptState`` (nested ``m``/``v`` trees there, dicts keyed by dotted
  parameter name here);
* ``cache_from_numpy`` / ``cache_to_numpy``: the serving path's
  ``TieredKVCache``;
* ``mamba_cache_from_numpy`` / ``mamba_cache_to_numpy``: the serving
  path's stacked ``MambaCache`` (ssm and hybrid families).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hotness import NeomemState, SketchState
from repro_torch.core.state import Counters, ThrashTable, TierState
from repro_torch.device import resolve_device
from repro_torch.memtier.kvcache import TieredKVCache
from repro_torch.models.ssm import MambaCache
from repro_torch.models.transformer import make_model
from repro_torch.obs.attribution import AttributionState
from repro_torch.obs.stats import TierStats
from repro_torch.obs.streaming import DetectorState
from repro_torch.obs.trace import MigrationRing
from repro_torch.optim.adamw import OptState, flat_params


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def _sub(tree, cls, device):
    return cls(*(_t(getattr(tree, f), device) for f in cls._fields))


def _hotness_from_numpy(tree, device):
    """The hotness provider's state subtree (None, SketchState or
    NeomemState), told apart by its field names."""
    if tree is None:
        return None
    for cls in (SketchState, NeomemState):
        if set(cls._fields) <= set(getattr(tree, "_fields", ())):
            return _sub(tree, cls, device)
    raise TypeError(f"unknown hotness state {type(tree).__name__}")


def state_from_numpy(tree, device="cuda") -> TierState:
    """The port's TierState from a reference TierState with numpy leaves,
    the detector, attribution and hotness-provider subtrees included."""
    device = resolve_device(device)

    def optional(f, cls):
        v = getattr(tree, f, None)
        return None if v is None else _sub(v, cls, device)

    top = {f: _t(getattr(tree, f), device)
           for f in ("tier", "hot", "last_access", "owner", "promo_scale",
                     "thrash_prev", "usage_prev", "freed_since", "steady",
                     "mitigated_prev")}
    return TierState(
        counters=_sub(tree.counters, Counters, device),
        table=_sub(tree.table, ThrashTable, device),
        stats=_sub(tree.stats, TierStats, device),
        ring=_sub(tree.ring, MigrationRing, device),
        t=int(np.asarray(tree.t)),
        det=optional("det", DetectorState),
        attrib=optional("attrib", AttributionState),
        hotness=_hotness_from_numpy(getattr(tree, "hotness", None), device),
        **top)


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
    """The port's model of ``cfg``'s family from a reference parameter tree
    whose leaves were made numpy arrays (``{"embed": {...}, "layers": {...}}``
    with a stacked layer axis, ``layers.moe`` for the moe family, plus
    ``"shared"`` for the hybrid; ``encoder``, ``decoder`` and the top-level
    leaf ``enc_ln`` for the encdec; ``units`` for the vlm, ``units.self``
    stacked [n_units, every - 1, ...] and the gates [n_units]). Names and
    layouts map one to one; every leaf must match the model's shape."""
    model = make_model(cfg, seed=None, device=device)
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


def _nest(flat: dict, leaf) -> dict:
    """A flat dict keyed by dotted name as the reference's nested tree,
    each value through ``leaf``."""
    tree: dict = {}
    for name, v in flat.items():
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf(v)
    return tree


def _f32_host(x: torch.Tensor) -> np.ndarray:
    """float32 numpy copy of a tensor (bf16 widens exactly)."""
    return x.detach().to(torch.float32).cpu().numpy().copy()


def params_to_numpy(model) -> dict:
    """The reference's nested parameter tree of a port model, float32
    numpy leaves (the inverse of ``params_from_numpy``)."""
    return _nest(flat_params(model), _f32_host)


def opt_state_from_numpy(tree, device="cuda") -> OptState:
    """The port's ``OptState`` from a reference ``OptState`` (or a dict with
    its fields) whose leaves were made numpy arrays: the nested ``m`` and
    ``v`` trees become float32 dicts keyed by dotted name, ``step`` an
    int32 scalar tensor."""
    device = resolve_device(device)

    def field(f):
        return tree[f] if isinstance(tree, dict) else getattr(tree, f)

    def flat(t):
        return {k: torch.as_tensor(np.array(v, np.float32), device=device)
                for k, v in flat_params(t).items()}

    return OptState(m=flat(field("m")), v=flat(field("v")),
                    step=torch.as_tensor(np.array(field("step"), np.int32),
                                         device=device))


def opt_state_to_numpy(opt: OptState) -> dict:
    """{"m", "v": the reference's nested trees of float32 arrays, "step":
    an int32 scalar array}."""
    return {"m": _nest(opt.m, _f32_host), "v": _nest(opt.v, _f32_host),
            "step": np.array(opt.step.cpu().numpy(), np.int32)}


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


def mamba_cache_from_numpy(tree, device="cuda") -> MambaCache:
    """The port's stacked ``MambaCache`` from a reference ``MambaCache``
    whose leaves were made numpy arrays (bf16 buffers as ml_dtypes)."""
    device = resolve_device(device)
    return MambaCache(*(_tensor_from_numpy(getattr(tree, f), device)
                        for f in MambaCache._fields))


def mamba_cache_to_numpy(cache: MambaCache) -> dict:
    """Dict of numpy arrays keyed by the reference's field names (bf16
    buffers widen exactly to float32)."""
    return {f: (v.to(torch.float32) if v.dtype == torch.bfloat16 else v
                ).cpu().numpy() for f, v in cache._asdict().items()}
