"""The shared "op trace invariant under parameter sweep" harness (torch port
of ``repro/analysis/constancy.py``).

Scale-independence is a load-bearing claim: the tick must not change shape
with tenant count or pool size — otherwise its host cost (one dispatch per
op, one launch per kernel) stops being O(1) in fleet size and a captured
graph stops being reusable. A signature is the op count and the aten op
histogram of one warm call, plus, on the card, the kernel launches of the
call (the ctypes kernels do not pass the dispatcher), so a rewrite that
keeps the op count but swaps ops, or a tick whose launches grow with T,
still trips.

Usage::

    sig = op_signature(fn, *args)                 # one warm call
    ok, sigs, diff = check_constant(build, params)   # sweep a parameter
      # where build(p) returns (fn, args) — built per parameter value

``diff`` names each divergent parameter with a per-op delta;
``assert_op_constant`` raises it as an AssertionError, so the failing op
mix is visible in the test output.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

from repro_torch.analysis.walk import OpTrace, record


class OpSignature(NamedTuple):
    """Structural fingerprint of one call."""
    n_ops: int
    ops: Tuple[Tuple[str, int], ...]        # sorted (aten op, count)
    launches: Tuple[Tuple[str, int], ...]   # sorted (kernel wrapper, n > 0)

    def histogram(self) -> dict:
        return dict(self.ops)

    def diff(self, other: "OpSignature") -> List[str]:
        """Human-readable per-op delta (empty iff equal)."""
        lines: List[str] = []
        if self.n_ops != other.n_ops:
            lines.append(f"op count: {self.n_ops} != {other.n_ops}")
        for label, a, b in (("", dict(self.ops), dict(other.ops)),
                            ("launches ", dict(self.launches),
                             dict(other.launches))):
            for name in sorted(set(a) | set(b)):
                if a.get(name, 0) != b.get(name, 0):
                    lines.append(f"  {label}{name}: {a.get(name, 0)} -> "
                                 f"{b.get(name, 0)}")
        return lines

    def __str__(self) -> str:
        return (f"OpSignature(ops={self.n_ops}, kinds={len(self.ops)}, "
                f"launches={dict(self.launches)})")


def signature_of(trace: OpTrace) -> OpSignature:
    """Signature of an already-recorded call."""
    return OpSignature(trace.n_ops, tuple(sorted(trace.op_histogram.items())),
                       tuple(sorted((k, v) for k, v in trace.launches.items()
                                    if v)))


def op_signature(fn: Callable, *args) -> OpSignature:
    """Call ``fn(*args)`` once to warm it (lazily built constants, kernel
    libraries), then record a second call and fingerprint it."""
    fn(*args)
    return signature_of(record(fn, *args))


def compare(sigs: Sequence[Tuple[object, OpSignature]]) -> List[str]:
    """Per-op diff of each signature of a sweep against the first, naming
    the parameters (empty iff all are equal)."""
    p0, base = sigs[0]
    return [f"param {p0!r} vs {p!r}: {line.strip()}"
            for p, sig in sigs[1:] for line in base.diff(sig)]


def check_constant(build: Callable, params: Sequence,
                   ) -> Tuple[bool, List[Tuple[object, OpSignature]],
                              List[str]]:
    """Build and fingerprint ``build(p)`` for each parameter value
    (``build(p)`` returns ``(fn, args)``). Returns (ok, [(param,
    signature), ...] in sweep order, diff)."""
    sigs = []
    for p in params:
        fn, args = build(p)
        sigs.append((p, op_signature(fn, *args)))
    diff = compare(sigs)
    return not diff, sigs, diff


def assert_op_constant(build: Callable, params: Sequence,
                       label: str = "") -> OpSignature:
    """``check_constant`` that raises AssertionError with the per-op diff
    on violation; returns the common signature."""
    ok, sigs, diff = check_constant(build, params)
    if not ok:
        raise AssertionError(f"op trace not constant"
                             f"{f' [{label}]' if label else ''}:\n"
                             + "\n".join(diff))
    return sigs[0][1]
