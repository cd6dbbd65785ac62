"""Parameter specs and their initialisation (torch port of the reference's
``models/params.py``).

A model declares a nested dict of ``ParamSpec`` (shape + init rule); layer
stacks carry a leading layer axis, as in the reference, so the parameter
tree has the reference's names and layouts and the weight conversion is one
to one. ``init_params`` draws every tensor from one seeded
``torch.Generator`` by the reference's rules (``init_params`` there): zeros,
ones, ``embed`` (std 1), ``small`` (std 0.02), else normal with std
``scale / sqrt(fan_in)``, where fan_in is the spec's first dimension — for
a stacked spec that is the layer count, exactly as the reference computes
it. Weights in a narrower ``param_dtype`` than float32 are drawn in float32
blocks of leading rows and rounded once. ``abstract_params`` is the tree as
tensors on the ``meta`` device (shapes and dtypes, no storage: the
reference's ``ShapeDtypeStruct`` tree); ``param_count`` and ``param_bytes``
size a spec tree. The streams differ from
``jax.random``'s, so the tests hand the reference's weights over through
``convert.params_from_numpy``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DRAW_BLOCK = 1 << 26      # float32 elements drawn at once for a narrower dtype


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("bfloat16", "float32")."""
    if name not in DTYPES:
        raise NotImplementedError(f"dtype {name!r} is not ported")
    return DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | zeros | ones | embed | small
    scale: float = 1.0


def stack_specs(specs: Dict, n: int) -> Dict:
    """Prepend a stacked layer dimension of size ``n`` to every spec."""
    return {k: stack_specs(v, n) if isinstance(v, dict)
            else ParamSpec((n,) + v.shape, v.init, v.scale)
            for k, v in specs.items()}


def init_param(spec: ParamSpec, generator: torch.Generator,
               device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if spec.shape else 1
    if spec.init == "embed":
        std = 1.0
    elif spec.init == "small":
        std = 0.02
    else:
        std = spec.scale / math.sqrt(max(fan_in, 1))
    if dtype == torch.float32 or len(spec.shape) < 2:
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)
    # a narrower dtype is drawn in float32 a block of leading rows at a time:
    # a whole stacked tensor in float32 (Mixtral's experts, 25.8 GB at depth
    # 8) would not fit beside the weights on one card
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    rows = max(1, DRAW_BLOCK // out[0].numel())
    for block in out.split(rows):
        block.copy_(torch.randn(block.shape, generator=generator,
                                dtype=torch.float32, device=device) * std)
    return out


def init_params(specs: Dict, generator: torch.Generator,
                device: torch.device, dtype: torch.dtype) -> Dict:
    """Concrete parameters for a spec tree, drawn in sorted key order (the
    reference's tree-flatten order) from ``generator``."""
    return {k: (init_params(specs[k], generator, device, dtype)
                if isinstance(specs[k], dict)
                else init_param(specs[k], generator, device, dtype))
            for k in sorted(specs)}


def empty_params(specs: Dict, device: torch.device,
                 dtype: torch.dtype) -> Dict:
    """Uninitialised parameters for a spec tree (filled by a conversion)."""
    return {k: (empty_params(v, device, dtype) if isinstance(v, dict)
                else torch.empty(v.shape, dtype=dtype, device=device))
            for k, v in specs.items()}


def _leaves(specs: Dict):
    for v in specs.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def abstract_params(specs: Dict, dtype: torch.dtype = torch.float32) -> Dict:
    """The parameter tree as ``meta`` tensors of ``dtype``: shapes and
    dtypes without storage."""
    return empty_params(specs, torch.device("meta"), dtype)


def param_count(specs: Dict) -> int:
    return int(sum(math.prod(s.shape) for s in _leaves(specs)))


def param_bytes(specs: Dict, dtype: torch.dtype = torch.float32) -> int:
    """Bytes of the parameters at ``dtype`` (the config's ``param_dtype``;
    a spec carries no dtype of its own here)."""
    return param_count(specs) * dtype.itemsize
