"""The op-trace recorder shared by every pass (torch port of
``repro/analysis/walk.py``).

torch has no jaxpr: what a torch program *is* is the sequence of aten ops
one call runs. ``record(fn, *args)`` runs the call under a
``TorchDispatchMode`` that sees every aten op — ``_local_scalar_dense``
from ``.item()`` and ``int(t)`` included — with its dtypes and the
innermost frame of the port that issued it, and lets data-dependent host
code run (``make_fx`` refuses ``.item()`` outright). The hand-written
kernels are called through ctypes and do not pass the dispatcher, so the
trace also keeps the delta of every kernel wrapper's ``.launches`` counter
across the call: the only record of them.

An ``OpTrace`` is the reference's ``ClosedJaxpr`` plus ``iter_eqns``: its
``op_histogram`` (op name -> count) and ``n_ops`` are what the constancy
checker compares, and the passes read its ``ops``.
"""
from __future__ import annotations

import ast
import contextlib
import functools
import os
import sys
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.interval import IntervalShadow

_PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the analysis machinery itself is never the frame an op is charged to
_MACHINERY = {os.path.join(_PORT_DIR, "analysis", f)
              for f in ("walk.py", "interval.py", "op_audit.py",
                        "constancy.py")}

# (tag, wrapper module, wrapper name): the eight kernel wrappers, each
# counting its kernel's launches in ``<wrapper>.launches``
KERNELS = (
    ("K1", "repro_torch.kernels.select.ops", "seg_topk"),
    ("K2", "repro_torch.kernels.select.ops", "seg_reduce"),
    ("K3", "repro_torch.kernels.select.ops", "seg_sums"),
    ("K4", "repro_torch.kernels.migrate.ops", "commit_moves"),
    ("K5", "repro_torch.kernels.tiered_attention.ops",
     "pool_attention_partial"),
    ("K6", "repro_torch.kernels.migrate.ops", "migrate_pages"),
    ("K7", "repro_torch.kernels.flash_attention.ops", "flash_attention"),
    ("K8", "repro_torch.kernels.ssd_scan.ops", "ssd_scan"),
)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by wrapper name."""
    import importlib
    return {name: getattr(importlib.import_module(mod), name).launches
            for _tag, mod, name in KERNELS}


def where(depth: int = 2) -> str:
    """The innermost frame of the port on the caller's stack, as
    ``file:function`` (path under ``src/repro_torch``, qualified name
    without ``<locals>``; never a line number)."""
    f = sys._getframe(depth)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PORT_DIR) and path not in _MACHINERY:
            rel = os.path.relpath(path, _PORT_DIR).replace(os.sep, "/")
            qual = f.f_code.co_qualname.replace(".<locals>", "")
            return f"{rel}:{qual}"
        f = f.f_back
    return "<top>"


@functools.lru_cache(maxsize=None)
def _functions(path: str) -> Tuple[Tuple[int, int, str], ...]:
    """(first line, last line, qualified name) of every function in a
    source file, outermost first."""
    out = []

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                if not isinstance(child, ast.ClassDef):
                    out.append((child.lineno, child.end_lineno, qual))
                visit(child, qual)
    with open(path) as fh:
        visit(ast.parse(fh.read()), "")
    return tuple(out)


def site_of(path: str, lineno: int) -> str:
    """``file:function`` of a source line of the port (as ``where``), or
    ``<top>`` for a line outside it."""
    if not path.startswith(_PORT_DIR) or path in _MACHINERY:
        return "<top>"
    rel = os.path.relpath(path, _PORT_DIR).replace(os.sep, "/")
    inner = [q for lo, hi, q in _functions(path) if lo <= lineno <= hi]
    return f"{rel}:{inner[-1] if inner else '<module>'}"


def _host_read(func, args, kwargs) -> Optional[str]:
    """Why this op reads device data on the host, or None. Each of these
    waits for the device (the value decides a shape or a host value)."""
    name = func._overloadpacket.__name__
    if name in ("_local_scalar_dense", "nonzero", "masked_select",
                "_unique2", "unique_dim", "unique_consecutive", "_unique",
                "is_nonzero", "equal"):
        return name
    if name in ("index", "_unsafe_index", "index_put", "index_put_"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(torch.is_tensor(i) and i.dtype == torch.bool
               for i in (idx or ())):
            return f"{name}-bool-mask"
    if name == "repeat_interleave":
        if func._overloadname.startswith("Tensor") and \
                kwargs.get("output_size") is None and len(args) < 4:
            return "repeat_interleave-no-output_size"
    if name in ("_to_copy", "copy_"):
        src = args[0] if name == "_to_copy" else args[1]
        dst_dev = (kwargs.get("device") if name == "_to_copy"
                   else args[0].device)
        if (torch.is_tensor(src) and src.device.type != "cpu"
                and dst_dev is not None
                and torch.device(dst_dev).type == "cpu"):
            return f"{name}-to-cpu"
    return None


def named_leaves(tree, prefix: str) -> List[Tuple[str, torch.Tensor]]:
    """The tensor leaves of a tree of NamedTuples, tuples, lists and dicts,
    named by their path (``state.counters.promotions``, ``inputs[0]``);
    None and host values (the tick counter ``t``) are skipped."""
    if torch.is_tensor(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, torch.Tensor]] = []
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            out += named_leaves(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            out += named_leaves(x, f"{prefix}[{i}]")
    elif isinstance(tree, dict):
        for k, x in tree.items():
            out += named_leaves(x, f"{prefix}[{k!r}]")
    return out


class OpRecord(NamedTuple):
    name: str                       # "cumsum.default"
    where: str                      # "core/tick.py:make_tick_core.tick"
    out_dtypes: Tuple[str, ...]
    host_read: Optional[str]        # see ``_host_read``
    syncs: int                      # sync warnings raised by this op


@dataclass
class OpTrace:
    """The op trace of one call."""
    ops: List[OpRecord]
    launches: Dict[str, int]        # kernel wrapper -> launches in the call
    result: Any = None
    shadow: Optional[IntervalShadow] = None
    # sync warnings raised outside any recorded op (card only): the
    # ``file:function`` of the port line that made the call, per warning
    stray_syncs: List[str] = field(default_factory=list)

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    @property
    def op_histogram(self) -> Dict[str, int]:
        return dict(Counter(op.name for op in self.ops))


def _is_sync(w) -> bool:
    return "called a synchronizing CUDA operation" in str(w.message)


class _Recorder(TorchDispatchMode):
    def __init__(self, shadow: Optional[IntervalShadow],
                 caught: Optional[list]):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.shadow = shadow
        self.caught = caught          # the warnings list, under sync debug
        self.seen = 0
        self.stray: List[str] = []

    def take_syncs(self) -> List[str]:
        """Sites of the sync warnings raised since the last look. A sync
        inside a composite torch call surfaces when the call returns to
        Python, so the warning's line is the port line that made it."""
        if self.caught is None:
            return []
        new = self.caught[self.seen:]
        self.seen = len(self.caught)
        return [site_of(w.filename, w.lineno) for w in new if _is_sync(w)]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.stray.extend(self.take_syncs())
        out = func(*args, **kwargs)
        syncs = len(self.take_syncs())
        site = where(2)
        if self.shadow is not None:
            self.shadow.step(func, args, kwargs, out, site)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append(OpRecord(
            name=f"{func._overloadpacket.__name__}.{func._overloadname}",
            where=site,
            out_dtypes=tuple(str(o.dtype).removeprefix("torch.")
                             for o in outs if torch.is_tensor(o)),
            host_read=_host_read(func, args, kwargs), syncs=syncs))
        return out


def record(fn: Callable, *args, shadow: Optional[IntervalShadow] = None,
           sync_debug: bool = False, **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` once and return its op trace.

    shadow: an ``IntervalShadow`` to push intervals through every op.
    sync_debug: on the card, run under ``torch.cuda.set_sync_debug_mode
    ("warn")`` and count each synchronising op's warnings on its record
    (warnings raised between ops land in ``stray_syncs``).
    """
    before = launch_counts()
    with contextlib.ExitStack() as stack:
        caught = None
        if sync_debug:
            caught = stack.enter_context(
                warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, prev)
        mode = _Recorder(shadow, caught)
        with mode:
            result = fn(*args, **kwargs)
        mode.stray.extend(mode.take_syncs())
    after = launch_counts()
    return OpTrace(ops=mode.ops,
                   launches={k: after[k] - before[k] for k in after},
                   result=result, shadow=shadow, stray_syncs=mode.stray)
