"""Interval analysis over the aten ops of a recorded torch call (torch port of
``repro/analysis/interval.py``).

An ``Interval`` abstracts every element of a tensor as one ``[lo, hi]``
range plus an ``integral`` bit (the value is an exact integer — either an
int dtype or a float produced only by int conversions and exact ops).
torch has no jaxpr to walk, so the reference's ``IntervalEvaluator`` over
jaxpr equations becomes a **shadow** (``IntervalShadow``) that rides beside
a live call: the recorder (``walk.record``) hands it every aten op as it
runs, and a rule table over aten op names computes each output's interval
from its inputs' intervals. The overflow pass can then answer the
reference's two questions:

  * how fast can each carried integer grow per tick (and therefore at what
    horizon does its dtype wrap)?
  * where does integer mass get converted into float32 beyond the 2^24
    exact-integer window?

Intervals are keyed by **storage**, not by tensor: a view reads its base's
interval, and an in-place write through a view (``index_add_``,
``index_copy_``, ``index_fill_``, ``index_put_``, ``copy_``) widens the
base — replacing it only when the write covers the whole storage. A tensor
read under another dtype than its storage was written with (``view.dtype``,
the bit-casts of hotness into the int32 ring and of K1's packed keys)
reads as its dtype's full range.

Sound-but-approximate by design: one interval per storage (no per-element
tracking), tensors the call did not produce (closure constants) read as
their concrete values, and an op without a rule gives its outputs their
dtype's full range, recorded in ``EvalContext.unknown_ops`` (the
reference's ``unknown_prims``), never silently. Python control flow is
host-side in the port (the tick counter ``t`` is a host int), so a call
sees one branch: the overflow pass runs each target in every host-side
phase and unions the results, as the reference's ``cond`` rule unions its
branches.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

INF = math.inf
# exact-integer window of float32 (2^24): integers beyond this silently
# lose units when accumulated in f32
F32_EXACT = float(1 << 24)
F16_EXACT = float(1 << 11)
BF16_EXACT = float(1 << 8)
_EXACT = {torch.float32: F32_EXACT, torch.float16: F16_EXACT,
          torch.bfloat16: BF16_EXACT}


class Interval(NamedTuple):
    lo: float
    hi: float
    integral: bool = False

    def union(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi),
                        self.integral and other.integral)

    def contains(self, other: "Interval") -> bool:
        return self.lo <= other.lo and other.hi <= self.hi

    def bounded(self) -> bool:
        return math.isfinite(self.lo) and math.isfinite(self.hi)


BOOL = Interval(0, 1, True)
TOP_F = Interval(-INF, INF, False)
# no value yet (``torch.empty``): the union's identity
BOTTOM = Interval(INF, -INF, True)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def dtype_interval(dtype: torch.dtype) -> Interval:
    """The full representable range of a dtype (the TOP element)."""
    if dtype == torch.bool:
        return BOOL
    if dtype.is_floating_point or dtype.is_complex:
        return TOP_F
    info = torch.iinfo(dtype)
    return Interval(float(info.min), float(info.max), True)


def value_interval(x) -> Interval:
    """Interval of a concrete tensor, array or Python number."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    t = x.detach()
    if t.numel() == 0:
        return Interval(0, 0, True)
    if t.is_complex():
        return TOP_F
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    lo, hi = float(t.min()), float(t.max())
    if math.isnan(lo) or math.isnan(hi):
        return TOP_F
    integral = not t.is_floating_point()
    if not integral:
        # a float constant holding exact integers keeps the integral bit
        # (e.g. 0.0 seeds of integral accumulators)
        integral = bool(torch.isfinite(t).all()
                        and (t == torch.round(t)).all())
    return Interval(lo, hi, integral)


def _mul(a: float, b: float) -> float:
    if a == 0 or b == 0:
        return 0.0
    return a * b


def add_iv(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo + b.lo, a.hi + b.hi, a.integral and b.integral)


def sub_iv(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo - b.hi, a.hi - b.lo, a.integral and b.integral)


def mul_iv(a: Interval, b: Interval) -> Interval:
    cs = [_mul(a.lo, b.lo), _mul(a.lo, b.hi), _mul(a.hi, b.lo),
          _mul(a.hi, b.hi)]
    return Interval(min(cs), max(cs), a.integral and b.integral)


def scale_iv(a: Interval, n: float) -> Interval:
    """a summed over n independent draws: [min(n*lo, lo), max(n*hi, hi)]
    (covers reductions over masked/partial extents)."""
    lo = min(_mul(a.lo, n), a.lo, 0.0)
    hi = max(_mul(a.hi, n), a.hi, 0.0)
    return Interval(lo, hi, a.integral)


def clip_to(iv: Interval, dtype: torch.dtype) -> Interval:
    """Intersect with a dtype's representable range: whatever the op did,
    the tensor cannot hold more."""
    top = dtype_interval(dtype)
    if iv.lo > iv.hi:                  # BOTTOM stays BOTTOM
        return iv
    is_int = not (dtype.is_floating_point or dtype.is_complex)
    return Interval(max(iv.lo, top.lo), min(iv.hi, top.hi),
                    iv.integral or is_int)


@dataclass
class Event:
    """One interval-analysis observation at a program point."""
    kind: str        # cast-truncate | cast-unbounded | cast-precision | bitcast
    where: str       # innermost port frame, ``file:function``
    slug: str        # stable identity for baseline keys
    detail: str


@dataclass
class EvalContext:
    events: List[Event] = field(default_factory=list)
    unknown_ops: Dict[str, int] = field(default_factory=dict)
    _slug_seq: Dict[str, int] = field(default_factory=dict)

    def next_slug(self, base: str) -> str:
        k = self._slug_seq.get(base, 0)
        self._slug_seq[base] = k + 1
        return base if k == 0 else f"{base}#{k}"


def storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _covers_storage(t: torch.Tensor) -> bool:
    return t.numel() * t.element_size() == t.untyped_storage().nbytes()


def _whole(t: torch.Tensor) -> torch.Tensor:
    """Every element of ``t``'s storage, read as ``t``'s dtype."""
    return t.new_empty(0).set_(t.untyped_storage())


def _bind(func, args, kwargs) -> dict:
    """An aten op's arguments by their schema names (defaults filled)."""
    out = {}
    for i, arg in enumerate(func._schema.arguments):
        if i < len(args):
            out[arg.name] = args[i]
        elif arg.name in kwargs:
            out[arg.name] = kwargs[arg.name]
        elif arg.has_default_value():
            out[arg.name] = arg.default_value
        else:
            out[arg.name] = None
    return out


class IntervalShadow:
    """Intervals beside a live call, one per storage (see module doc)."""

    def __init__(self, ctx: Optional[EvalContext] = None):
        self.ctx = ctx or EvalContext()
        self.env: Dict[int, Tuple[Interval, torch.dtype]] = {}
        # storage key -> live tensors seen on it; an entry dies with its
        # last tensor, so a freed storage's address that comes back under a
        # tensor made outside the dispatcher (``torch.from_numpy``) cannot
        # inherit a stale interval
        self._live: Dict[int, int] = {}
        self._watched: Dict[int, int] = {}

    def _watch(self, t: torch.Tensor) -> int:
        key = storage_key(t)
        if id(t) not in self._watched:
            self._watched[id(t)] = key
            self._live[key] = self._live.get(key, 0) + 1
            weakref.finalize(t, self._release, id(t), key)
        return key

    def _release(self, tid: int, key: int) -> None:
        self._watched.pop(tid, None)
        n = self._live.pop(key, 1) - 1
        if n > 0:
            self._live[key] = n
        else:
            self.env.pop(key, None)

    def _set(self, t: torch.Tensor, iv: Interval, dtype: torch.dtype) -> None:
        self.env[self._watch(t)] = (iv, dtype)

    def seed(self, t: torch.Tensor, iv: Interval) -> None:
        self._set(t, clip_to(iv, t.dtype), t.dtype)

    def iv(self, x) -> Interval:
        """Interval of an op argument: a tensor, a Python number or None."""
        if torch.is_tensor(x):
            got = self.env.get(storage_key(x))
            if got is None:
                # a tensor the call did not produce: a constant, read
                # whole (the interval is the storage's, and a later view
                # of another part of it inherits it)
                got = (value_interval(_whole(x)), x.dtype)
                self._set(x, *got)
            iv, dtype = got
            return iv if dtype == x.dtype else dtype_interval(x.dtype)
        if isinstance(x, bool):
            return Interval(float(x), float(x), True)
        if isinstance(x, (int, float)):
            v = float(x)
            return (Interval(v, v, v == round(v)) if math.isfinite(v)
                    else Interval(v, v, False))
        return TOP_F

    # ----------------------------------------------------------- stepping
    def step(self, func, args, kwargs, out, where: str) -> None:
        """Push intervals through one aten op that has just run."""
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if torch.is_tensor(o)]
        if not outs:
            return
        name = func._overloadpacket.__name__
        returns = func._schema.returns
        writes = [i for i, r in enumerate(returns) if r.alias_info is not None
                  and r.alias_info.is_write]
        if not writes and all(r.alias_info is not None for r in returns):
            # a pure view: same storage, same values
            for o in outs:
                self._watch(o)
            if name == "view" and func._overloadname == "dtype":
                self._bitcast(args[0], outs[0], where)
            elif name.startswith("lift"):
                # a tensor just made from host data (``torch.as_tensor``):
                # a constant
                self._set(outs[0], value_interval(outs[0]), outs[0].dtype)
            return
        base = (name[:-1] if writes and name.endswith("_")
                and not name.startswith("__") else name)
        rule = _RULES.get(base)
        a = _bind(func, args, kwargs)
        if rule is None:
            self.ctx.unknown_ops[name] = self.ctx.unknown_ops.get(name, 0) + 1
            ivs = [dtype_interval(o.dtype) for o in outs]
        else:
            ivs = rule(self, a, outs, where)
        for i, (o, iv) in enumerate(zip(outs, ivs)):
            iv = clip_to(iv, o.dtype)
            if i in writes or (writes and len(outs) == 1):
                old = self.env.get(storage_key(o))
                if old is not None and old[1] != o.dtype:
                    # written through a reinterpreting view: widen the base
                    self._set(o, dtype_interval(old[1]), old[1])
                    continue
                if not _covers_storage(o):
                    # the rest of the storage keeps its values; one never
                    # seen before is a constant, read whole (its written
                    # part included: a superset)
                    if old is None:
                        old = (value_interval(_whole(o)), o.dtype)
                    iv = old[0].union(iv)
            self._set(o, iv, o.dtype)

    # -------------------------------------------------------------- casts
    def cast(self, a: Interval, new_dtype: torch.dtype, where: str
             ) -> Interval:
        """The reference's ``convert_element_type`` rule, events included."""
        if new_dtype == torch.bool:
            return BOOL
        name = dtype_name(new_dtype)
        if not (new_dtype.is_floating_point or new_dtype.is_complex):
            top = dtype_interval(new_dtype)
            if a.lo > a.hi:
                return a
            if a.bounded() and top.contains(Interval(a.lo, a.hi, True)):
                return Interval(math.floor(a.lo), math.ceil(a.hi), True)
            # a *finite* bound provably exceeding the target range is a
            # real truncation; an unbounded one is usually analysis
            # over-approximation — downgraded to a note by the pass
            kind = "cast-truncate" if a.bounded() else "cast-unbounded"
            self.ctx.events.append(Event(
                kind=kind, where=where,
                slug=self.ctx.next_slug(f"cast-{name}@{where}"),
                detail=f"cast to {name} from range [{a.lo:g}, {a.hi:g}] "
                       f"can wrap"))
            return top
        exact = _EXACT.get(new_dtype)
        if (a.integral and exact is not None and a.lo <= a.hi
                and max(abs(a.lo), abs(a.hi)) > exact):
            self.ctx.events.append(Event(
                kind="cast-precision", where=where,
                slug=self.ctx.next_slug(f"cast-{name}-precision@{where}"),
                detail=f"integer mass up to {max(abs(a.lo), abs(a.hi)):g} "
                       f"cast to {name} (exact only to {exact:g}) — "
                       f"accumulation drops units"))
        return Interval(a.lo, a.hi, a.integral)

    def _bitcast(self, src: torch.Tensor, out: torch.Tensor,
                 where: str) -> None:
        """``view.dtype``: the bits reinterpreted. Readers of ``out`` see its
        dtype's range (the storage keeps its own dtype); an event records
        the reinterpretation unless the values provably survive it."""
        a = self.iv(src)
        same_kind = not (src.dtype.is_floating_point
                         or out.dtype.is_floating_point)
        if same_kind and dtype_interval(out.dtype).contains(a):
            return
        name = dtype_name(out.dtype)
        self.ctx.events.append(Event(
            kind="bitcast", where=where,
            slug=self.ctx.next_slug(f"cast-{name}@{where}"),
            detail=f"bit-cast {dtype_name(src.dtype)} [{a.lo:g}, {a.hi:g}] "
                   f"to {name}: the value range is not preserved"))


# --------------------------------------------------------------- rules ----
# rule(shadow, bound_args, output_tensors, where) -> [Interval per output]
Rule = Callable[[IntervalShadow, dict, list, str], List[Interval]]


def _extent(t: torch.Tensor, dim) -> float:
    if dim is None or (isinstance(dim, (list, tuple)) and len(dim) == 0):
        return float(max(t.numel(), 1))
    dims = dim if isinstance(dim, (list, tuple)) else (dim,)
    n = 1
    for d in dims:
        n *= int(t.shape[d]) if t.dim() else 1
    return float(max(n, 1))


def _index_range(n: float) -> Interval:
    return Interval(0, float(max(n - 1, 0)), True)


def _same(arg: str = "self") -> Rule:
    return lambda sh, a, outs, w: [sh.iv(a[arg])] * len(outs)


def _const(iv: Interval) -> Rule:
    return lambda sh, a, outs, w: [iv] * len(outs)


def _value(arg: str) -> Rule:
    return lambda sh, a, outs, w: [sh.iv(a[arg])]


def _union_of(*args: str) -> Rule:
    def rule(sh, a, outs, w):
        out = BOTTOM
        for k in args:
            out = out.union(sh.iv(a[k]))
        return [out]
    return rule


def _union_list(sh, a, outs, w):
    out = BOTTOM
    for t in a["tensors"]:
        out = out.union(sh.iv(t))
    return [out]


def _alpha(sh, a) -> Interval:
    return sh.iv(a.get("alpha", 1) if a.get("alpha") is not None else 1)


def _add(sh, a, outs, w):
    return [add_iv(sh.iv(a["self"]), mul_iv(sh.iv(a["other"]), _alpha(sh, a)))]


def _sub(sh, a, outs, w):
    return [sub_iv(sh.iv(a["self"]), mul_iv(sh.iv(a["other"]), _alpha(sh, a)))]


def _rsub(sh, a, outs, w):
    return [sub_iv(sh.iv(a["other"]), mul_iv(sh.iv(a["self"]), _alpha(sh, a)))]


def _mul_rule(sh, a, outs, w):
    return [mul_iv(sh.iv(a["self"]), sh.iv(a["other"]))]


def _div(sh, a, outs, w):
    x, y = sh.iv(a["self"]), sh.iv(a["other"])
    mode = a.get("rounding_mode")
    if y.lo > 0 or y.hi < 0:
        cs = [x.lo / y.lo, x.lo / y.hi, x.hi / y.lo, x.hi / y.hi]
        lo, hi = min(cs), max(cs)
        if mode in ("floor", "trunc"):
            return [Interval(math.floor(lo) if math.isfinite(lo) else lo,
                             math.ceil(hi) if math.isfinite(hi) else hi,
                             True)]
        return [Interval(lo, hi, False)]
    return [dtype_interval(outs[0].dtype)]


def _remainder(sh, a, outs, w):
    # torch.remainder takes the divisor's sign (Python's %)
    y = sh.iv(a["other"])
    m = max(abs(y.lo), abs(y.hi))
    if not math.isfinite(m):
        return [dtype_interval(outs[0].dtype)]
    integral = sh.iv(a["self"]).integral and y.integral
    if y.lo > 0:
        return [Interval(0.0, y.hi, integral)]
    if y.hi < 0:
        return [Interval(y.lo, 0.0, integral)]
    return [Interval(-m, m, integral)]


def _fmod(sh, a, outs, w):
    # C-style remainder (the dividend's sign), the reference's ``rem``
    x, y = sh.iv(a["self"]), sh.iv(a["other"])
    m = max(abs(y.lo), abs(y.hi))
    if not math.isfinite(m):
        return [dtype_interval(outs[0].dtype)]
    return [Interval(0.0 if x.lo >= 0 else -m, m if x.hi > 0 else 0.0,
                     x.integral and y.integral)]


def _neg(sh, a, outs, w):
    x = sh.iv(a["self"])
    return [Interval(-x.hi, -x.lo, x.integral)]


def _abs(sh, a, outs, w):
    x = sh.iv(a["self"])
    lo = 0.0 if x.lo <= 0 <= x.hi else min(abs(x.lo), abs(x.hi))
    return [Interval(lo, max(abs(x.lo), abs(x.hi)), x.integral)]


def _max_iv(x: Interval, y: Interval) -> Interval:
    return Interval(max(x.lo, y.lo), max(x.hi, y.hi), x.integral and y.integral)


def _min_iv(x: Interval, y: Interval) -> Interval:
    return Interval(min(x.lo, y.lo), min(x.hi, y.hi), x.integral and y.integral)


def _maximum(sh, a, outs, w):
    return [_max_iv(sh.iv(a["self"]), sh.iv(a["other"]))]


def _minimum(sh, a, outs, w):
    return [_min_iv(sh.iv(a["self"]), sh.iv(a["other"]))]


def _clamp(sh, a, outs, w):
    x = sh.iv(a["self"])
    if a.get("min") is not None:
        x = _max_iv(x, sh.iv(a["min"]))
    if a.get("max") is not None:
        x = _min_iv(x, sh.iv(a["max"]))
    return [x]


def _clamp_min(sh, a, outs, w):
    return [_max_iv(sh.iv(a["self"]), sh.iv(a["min"]))]


def _clamp_max(sh, a, outs, w):
    return [_min_iv(sh.iv(a["self"]), sh.iv(a["max"]))]


def _floor_like(sh, a, outs, w):
    x = sh.iv(a["self"])
    return [Interval(math.floor(x.lo) if math.isfinite(x.lo) else x.lo,
                     math.ceil(x.hi) if math.isfinite(x.hi) else x.hi, True)]


def _monotone(fn: Callable[[float], float], domain_lo: float) -> Rule:
    """An increasing function defined above ``domain_lo``."""
    def rule(sh, a, outs, w):
        x = sh.iv(a["self"])
        if x.lo > domain_lo and x.lo <= x.hi:
            return [Interval(fn(x.lo), fn(x.hi) if math.isfinite(x.hi)
                             else INF, False)]
        return [TOP_F]
    return rule


def _exp(sh, a, outs, w):
    x = sh.iv(a["self"])
    return [Interval(math.exp(min(x.lo, 700)) if math.isfinite(x.lo) else 0.0,
                     math.exp(min(x.hi, 700)) if math.isfinite(x.hi) else INF,
                     False)]


def _sqrt(sh, a, outs, w):
    x = sh.iv(a["self"])
    return [Interval(math.sqrt(max(x.lo, 0.0)),
                     math.sqrt(x.hi) if x.hi >= 0 else 0.0, False)]


def _pow_scalar(sh, a, outs, w):
    x, y = sh.iv(a["self"]), a["exponent"]
    if isinstance(y, int) and y >= 0 and x.bounded():
        cs = [x.lo ** y, x.hi ** y]
        if x.lo <= 0 <= x.hi:
            cs.append(0.0)
        return [Interval(min(cs), max(cs), x.integral)]
    return [dtype_interval(outs[0].dtype)]


def _bool_or_range(fn: Callable) -> Rule:
    def rule(sh, a, outs, w):
        if outs[0].dtype == torch.bool:
            return [BOOL]
        return [fn(sh, a, outs[0].dtype)]
    return rule


def _nonneg_bits(hi: float) -> float:
    return float((1 << max(int(hi), 0).bit_length()) - 1)


def _and(sh, a, dtype):
    x, y = sh.iv(a["self"]), sh.iv(a["other"])
    if x.lo >= 0 and y.lo >= 0:
        return Interval(0, min(x.hi, y.hi), True)
    if x.lo >= 0 or y.lo >= 0:     # masking by a non-negative operand
        return Interval(0, x.hi if x.lo >= 0 else y.hi, True)
    return dtype_interval(dtype)


def _or_xor(sh, a, dtype):
    x, y = sh.iv(a["self"]), sh.iv(a["other"])
    if x.lo >= 0 and y.lo >= 0 and x.bounded() and y.bounded():
        return Interval(0, _nonneg_bits(max(x.hi, y.hi)), True)
    return dtype_interval(dtype)


def _not(sh, a, dtype):
    x = sh.iv(a["self"])               # ~x == -x - 1
    return Interval(-x.hi - 1, -x.lo - 1, True)


def _lshift(sh, a, dtype):
    x, y = sh.iv(a["self"]), sh.iv(a["other"])
    if x.lo >= 0 and y.lo >= 0 and y.hi < 64 and x.bounded():
        return Interval(x.lo * 2.0 ** y.lo, x.hi * 2.0 ** y.hi, True)
    return dtype_interval(dtype)


def _rshift(sh, a, dtype):
    x, y = sh.iv(a["self"]), sh.iv(a["other"])
    if x.lo >= 0 and y.lo >= 0 and x.bounded():
        return Interval(math.floor(x.lo / 2.0 ** min(y.hi, 64)),
                        math.floor(x.hi / 2.0 ** y.lo), True)
    return dtype_interval(dtype)


def _where(sh, a, outs, w):
    return [sh.iv(a["self"]).union(sh.iv(a["other"]))]


def _masked_fill(sh, a, outs, w):
    return [sh.iv(a["self"]).union(sh.iv(a["value"]))]


def _sum(sh, a, outs, w):
    return [scale_iv(sh.iv(a["self"]), _extent(a["self"], a.get("dim")))]


def _cumsum(sh, a, outs, w):
    return [scale_iv(sh.iv(a["self"]), _extent(a["self"], a["dim"]))]


def _mean(sh, a, outs, w):
    x = sh.iv(a["self"])
    return [Interval(x.lo, x.hi, False)]


def _values_indices(sh, a, outs, w):
    """(values, indices) of a sort / top-k / max-over-dim."""
    dim = a.get("dim", -1)
    n = _extent(a["self"], -1 if dim is None else dim)
    return [sh.iv(a["self"]), _index_range(n)][:len(outs)]


def _max_or_min(binary: Rule) -> Rule:
    """``max``/``min``: elementwise with ``other``, else a reduction."""
    def rule(sh, a, outs, w):
        if a.get("other") is not None:
            return binary(sh, a, outs, w)
        return _values_indices(sh, a, outs, w)
    return rule


def _square(sh, a, outs, w):
    x = sh.iv(a["self"])
    p = mul_iv(x, x)
    return [Interval(max(p.lo, 0.0), p.hi, x.integral)]


def _argsort(sh, a, outs, w):
    return [_index_range(_extent(a["self"], a.get("dim", -1)))]


def _arg_reduce(sh, a, outs, w):
    return [_index_range(_extent(a["self"], a.get("dim")))]


def _searchsorted(sh, a, outs, w):
    return [Interval(0, float(a["sorted_sequence"].shape[-1]), True)]


def _bucketize(sh, a, outs, w):
    return [Interval(0, float(a["boundaries"].numel()), True)]


def _nonzero(sh, a, outs, w):
    t = a["self"]
    return [_index_range(max(t.shape) if t.dim() else 1)]


def _index_put(sh, a, outs, w):
    base, vals = sh.iv(a["self"]), sh.iv(a["values"])
    if a.get("accumulate"):
        n = max([a["values"].numel()] + [i.numel() for i in a["indices"]
                                         if i is not None])
        return [add_iv(base, scale_iv(vals, float(n)))]
    return [base.union(vals)]


def _index_add(sh, a, outs, w):
    src = mul_iv(sh.iv(a["source"]), _alpha(sh, a))
    return [add_iv(sh.iv(a["self"]),
                   scale_iv(src, float(max(a["index"].numel(), 1))))]


def _scatter(sh, a, outs, w):
    src = a.get("src")
    return [sh.iv(a["self"]).union(sh.iv(src if src is not None
                                         else a["value"]))]


def _scatter_add(sh, a, outs, w):
    return [add_iv(sh.iv(a["self"]),
                   scale_iv(sh.iv(a["src"]), float(max(a["index"].numel(),
                                                        1))))]


def _scatter_reduce(sh, a, outs, w):
    base, src = sh.iv(a["self"]), sh.iv(a["src"])
    n = float(max(a["index"].numel(), 1))
    if a["reduce"] == "sum":
        total = scale_iv(src, n)
        return [add_iv(base, total) if a.get("include_self", True)
                else base.union(total)]
    if a["reduce"] in ("amax", "amin", "mean"):
        return [base.union(src)]
    return [dtype_interval(outs[0].dtype)]


def _arange(sh, a, outs, w):
    o = outs[0]
    n = o.numel()
    if n == 0:
        return [BOTTOM]
    start = float(a.get("start") or 0)
    step = float(a.get("step") or 1)
    last = start + step * (n - 1)
    return [Interval(min(start, last), max(start, last),
                     start == round(start) and step == round(step))]


def _to_copy(sh, a, outs, w):
    x = sh.iv(a["self"])
    new = a.get("dtype")
    if new is None or new == a["self"].dtype:
        return [x]
    return [sh.cast(x, new, w)]


def _copy(sh, a, outs, w):
    src = a["src"]
    x = sh.iv(src)
    if src.dtype == outs[0].dtype:
        return [x]
    return [sh.cast(x, outs[0].dtype, w)]


def _mm(sh, a, outs, w):
    x, y = a["self"], a.get("mat2", a.get("other"))
    k = float(x.shape[-1]) if x.dim() else 1.0
    return [scale_iv(mul_iv(sh.iv(x), sh.iv(y)), k)]


def _addmm(sh, a, outs, w):
    m1, m2 = a["mat1"], a["mat2"]
    prod = scale_iv(mul_iv(sh.iv(m1), sh.iv(m2)), float(m1.shape[-1]))
    return [add_iv(mul_iv(sh.iv(a["self"]), sh.iv(a["beta"])),
                   mul_iv(prod, sh.iv(a["alpha"])))]


_BOOL_OUT = ("eq", "ne", "lt", "le", "gt", "ge", "isfinite", "isnan",
             "isinf", "isneginf", "isposinf", "logical_and", "logical_or",
             "logical_not", "logical_xor", "any", "all", "isin", "signbit")
_SAME = ("view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
         "expand_as", "unsqueeze", "squeeze", "select", "slice", "narrow",
         "permute", "transpose", "t", "clone", "detach", "alias",
         "contiguous", "lift_fresh", "lift_fresh_copy", "flatten",
         "unflatten", "as_strided", "repeat", "flip", "roll", "movedim",
         "diagonal", "unfold", "tile", "index_select", "gather", "take",
         "take_along_dim", "index", "masked_select", "split",
         "split_with_sizes", "unbind", "chunk", "amax", "amin",
         "_unsafe_index", "repeat_interleave", "broadcast_to", "tril",
         "triu", "constant_pad_nd", "max_pool2d")

_RULES: Dict[str, Rule] = {
    **{k: _same() for k in _SAME},
    **{k: _const(BOOL) for k in _BOOL_OUT},
    "add": _add, "sub": _sub, "rsub": _rsub, "mul": _mul_rule, "div": _div,
    "floor_divide": lambda sh, a, outs, w: _div(
        sh, {**a, "rounding_mode": "floor"}, outs, w),
    "remainder": _remainder, "fmod": _fmod, "neg": _neg, "abs": _abs,
    "sign": _const(Interval(-1, 1, True)), "sgn": _const(Interval(-1, 1,
                                                                  True)),
    "maximum": _maximum, "minimum": _minimum, "fmax": _maximum,
    "fmin": _minimum, "clamp": _clamp, "clamp_min": _clamp_min,
    "clamp_max": _clamp_max, "floor": _floor_like, "ceil": _floor_like,
    "round": _floor_like, "trunc": _floor_like,
    "exp": _exp, "log": _monotone(math.log, 0.0),
    "log2": _monotone(math.log2, 0.0), "log1p": _monotone(math.log1p, -1.0),
    "sqrt": _sqrt, "rsqrt": _const(Interval(0, INF, False)),
    "sigmoid": _const(Interval(0, 1, False)),
    "tanh": _const(Interval(-1, 1, False)),
    "erf": _const(Interval(-1, 1, False)),
    "sin": _const(Interval(-1, 1, False)),
    "cos": _const(Interval(-1, 1, False)),
    "_softmax": _const(Interval(0, 1, False)),
    "softmax": _const(Interval(0, 1, False)),
    "_log_softmax": _const(Interval(-INF, 0, False)),
    "pow": _pow_scalar, "square": _square,
    "bitwise_and": _bool_or_range(_and), "__and__": _bool_or_range(_and),
    "bitwise_or": _bool_or_range(_or_xor), "__or__": _bool_or_range(_or_xor),
    "bitwise_xor": _bool_or_range(_or_xor),
    "__xor__": _bool_or_range(_or_xor),
    "bitwise_not": _bool_or_range(_not),
    "bitwise_left_shift": _bool_or_range(_lshift),
    "__lshift__": _bool_or_range(_lshift),
    "bitwise_right_shift": _bool_or_range(_rshift),
    "__rshift__": _bool_or_range(_rshift),
    "where": _where, "masked_fill": _masked_fill,
    "masked_scatter": _union_of("self", "source"),
    "sum": _sum, "nansum": _sum, "cumsum": _cumsum, "mean": _mean,
    "max": _max_or_min(_maximum), "min": _max_or_min(_minimum),
    "sort": _values_indices,
    "topk": _values_indices, "kthvalue": _values_indices,
    "cummax": _values_indices, "cummin": _values_indices,
    "argsort": _argsort, "argmax": _arg_reduce, "argmin": _arg_reduce,
    "searchsorted": _searchsorted, "bucketize": _bucketize,
    "nonzero": _nonzero,
    "cat": _union_list, "stack": _union_list,
    "index_put": _index_put, "index_add": _index_add,
    "index_copy": _union_of("self", "source"),
    "index_fill": _union_of("self", "value"),
    "scatter": _scatter, "scatter_add": _scatter_add,
    "scatter_reduce": _scatter_reduce,
    "fill": _value("value"), "zero": _const(Interval(0, 0, True)),
    "arange": _arange,
    "full": _value("fill_value"), "full_like": _value("fill_value"),
    "new_full": _value("fill_value"), "scalar_tensor": _value("s"),
    "zeros": _const(Interval(0, 0, True)),
    "zeros_like": _const(Interval(0, 0, True)),
    "new_zeros": _const(Interval(0, 0, True)),
    "ones": _const(Interval(1, 1, True)),
    "ones_like": _const(Interval(1, 1, True)),
    "new_ones": _const(Interval(1, 1, True)),
    "empty": _const(BOTTOM), "empty_like": _const(BOTTOM),
    "new_empty": _const(BOTTOM), "empty_strided": _const(BOTTOM),
    "new_empty_strided": _const(BOTTOM),
    "rand": _const(Interval(0, 1, False)),
    "rand_like": _const(Interval(0, 1, False)),
    "_to_copy": _to_copy, "copy": _copy,
    "mm": _mm, "bmm": _mm, "matmul": _mm, "addmm": _addmm,
}
