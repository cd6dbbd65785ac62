"""Composable audit passes over op traces (torch port of
``repro/analysis/jaxpr_audit.py``; the passes keep their names so the two
baselines read side by side).

Each pass inspects the op traces (``walk.record``) of one target and
appends :class:`~repro_torch.analysis.findings.Finding` objects to a
shared :class:`~repro_torch.analysis.findings.Report`:

  purity_pass    — the tick must not read device data on the host: no
                   ``_local_scalar_dense`` (``.item()``, ``int(t)``),
                   ``nonzero``, ``masked_select``, ``unique``, boolean-mask
                   indexing, ``repeat_interleave`` without ``output_size``
                   or copy to the CPU; on the card, every op that
                   ``torch.cuda.set_sync_debug_mode("warn")`` flags, and
                   the capture probe: a tick that ``torch.cuda.graph``
                   cannot capture (the cuda tick at C1's size, one graph
                   per controller phase, tried in a child process, so a
                   failed capture cannot poison this process's CUDA
                   context). In XLA a pure tick is one program; in torch,
                   a tick that captures is.
  dtype_pass     — no float64 or complex produced anywhere (the deliberate
                   single-rounding sites are baselined), carried state keeps
                   its declared width, and no carried leaf or tick output
                   is 64-bit. int64 is torch's index dtype and is flagged
                   only on a carried leaf or an output, never on an index.
                   Python scalars wrapped as 0-dim tensors (``scalar_tensor``,
                   torch's weak types) do not promote and are exempt; the
                   reference's weak-type output check has no torch
                   counterpart (a torch tensor is never weakly typed).
  overflow_pass  — interval analysis (:mod:`repro_torch.analysis.interval`)
                   over the integer dataflow: per-tick growth of each
                   carried counter, extrapolated to the declared fleet
                   horizon, plus int->narrow-int cast and int->float32
                   precision-loss events.
  donation_pass  — what donation buys in XLA (O(1) rollout memory) in
                   torch terms: a donated input is updated in place (an
                   output shares its storage), and ``steady_memory_pass``:
                   a rollout's state bytes (and on the card
                   ``torch.cuda.memory_allocated()``) never grow past their
                   value after the second tick.
  launch_pass    — a kernel target whose wrapper, handed CUDA tensors, did
                   not launch its kernel.

Passes never raise on violations — they report. The CLI/gate decides
what is fatal by diffing against the committed baseline.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.interval import (EvalContext, Interval,
                                           IntervalShadow, dtype_interval,
                                           dtype_name, value_interval)
from repro_torch.analysis.walk import OpTrace, named_leaves, record

_WIDE_OPS = {"float64", "complex64", "complex128"}
_WIDE_LEAVES = {"float64", "int64", "uint64", "complex64", "complex128"}


def _numbered(bases: Sequence[str]) -> List[str]:
    """``base``, ``base#1``, ... for repeated bases, in order."""
    seen: Dict[str, int] = {}
    out = []
    for b in bases:
        k = seen.get(b, 0)
        seen[b] = k + 1
        out.append(b if k == 0 else f"{b}#{k}")
    return out


# --------------------------------------------------------------- purity ----
def purity_pass(traces: Sequence[OpTrace], target: str,
                report: Report) -> None:
    """No host reads of device data, no synchronising op (card)."""
    found: Dict[str, str] = {}
    for tr in traces:
        reads = [op for op in tr.ops if op.host_read]
        for op, slug in zip(reads, _numbered(
                [f"{op.host_read}@{op.where}" for op in reads])):
            found.setdefault(slug, f"host read `{op.name}` at {op.where} — "
                             f"the tick must not wait on the device (no "
                             f"host round trips on the hot path)")
        syncs = [op for op in tr.ops if op.syncs]
        for op, slug in zip(syncs, _numbered(
                [f"sync:{op.name}@{op.where}" for op in syncs])):
            found.setdefault(slug, f"`{op.name}` at {op.where} synchronises "
                             f"with the device (set_sync_debug_mode)")
        for site, slug in zip(tr.stray_syncs, _numbered(
                [f"sync@{site}" for site in tr.stray_syncs])):
            found.setdefault(slug, f"a torch call at {site} synchronises "
                             f"with the device inside a composite op "
                             f"(set_sync_debug_mode)")
    for slug, msg in sorted(found.items()):
        report.add(Finding("purity", target, slug, msg))


def capture_pass(verdict: dict, target: str, report: Report) -> None:
    """A controller phase whose tick ``torch.cuda.graph`` could not
    capture (or whose replay differs from eager) is a finding."""
    for v in verdict["phases"]:
        if not v["ok"]:
            report.add(Finding(
                "purity", target,
                f"capture:{v['phase']}@{v.get('where') or '<top>'}",
                f"torch.cuda.graph could not capture the {v['phase']} "
                f"phase of one tick: {v.get('error', '')[:400]}"))


# ---------------------------------------------------------------- dtype ----
def dtype_pass(traces: Sequence[OpTrace], target: str, report: Report,
               carry: Sequence[Tuple[str, torch.dtype, torch.dtype]] = (),
               outputs: Sequence[Tuple[str, torch.dtype]] = ()) -> None:
    """No float64/complex produced; stable carry widths; no 64-bit carried
    leaf or output.

    carry: (leaf name, dtype before the tick, dtype after) of each carried
    state leaf; outputs: (leaf name, dtype) of every carried leaf after the
    tick and every tick output."""
    seen = set()
    for tr in traces:
        for op in tr.ops:
            if op.name.startswith("scalar_tensor."):
                continue          # a wrapped Python number: never promotes
            for d in op.out_dtypes:
                if d in _WIDE_OPS and (d, op.where) not in seen:
                    seen.add((d, op.where))
                    report.add(Finding(
                        "dtype", target, f"{d}@{op.where}",
                        f"`{op.name}` produces {d} at {op.where} — the "
                        f"port computes in 32 bits; a {d} value on the hot "
                        f"path doubles its bytes"))
    for name, d_in, d_out in carry:
        if d_in != d_out:
            report.add(Finding(
                "dtype", target, f"width-change:{name}",
                f"carried state leaf `{name}` enters as {dtype_name(d_in)} "
                f"but leaves as {dtype_name(d_out)} — declared widths in "
                f"core/state.py must survive the tick (torch widens int32 "
                f"sum/cumsum to int64 unless given a dtype)"))
    for name, d in outputs:
        if dtype_name(d) in _WIDE_LEAVES:
            report.add(Finding(
                "dtype", target, f"{dtype_name(d)}@{name}",
                f"`{name}` is {dtype_name(d)}: carried state and tick "
                f"outputs keep the reference's 32-bit widths"))


def carry_dtypes(before, after, prefix: str = "state"
                 ) -> List[Tuple[str, torch.dtype, torch.dtype]]:
    """(name, dtype before, dtype after) of every carried leaf."""
    out = dict(named_leaves(after, prefix))
    return [(n, t.dtype, out[n].dtype) for n, t in named_leaves(before, prefix)
            if n in out]


# ------------------------------------------------------------- overflow ----
def _seeded_record(fn: Callable, args: tuple, names: Sequence[str],
                   seeds: Dict[str, Interval], ctx: EvalContext) -> OpTrace:
    shadow = IntervalShadow(ctx)
    for name, arg in zip(names, args):
        for leaf, t in named_leaves(arg, name):
            if leaf in seeds:
                shadow.seed(t, seeds[leaf])
    return record(fn, *args, shadow=shadow)


def _carried_out(trace: OpTrace, carry: Tuple[int, int],
                 name: str) -> Dict[str, Interval]:
    tree = trace.result[carry[1]]
    return {leaf: trace.shadow.iv(t) for leaf, t in named_leaves(tree, name)}


def overflow_pass(fn: Callable, phases: Sequence[tuple],
                  names: Sequence[str], target: str, report: Report,
                  input_ivals: Dict[str, Interval],
                  carry: Optional[Tuple[int, int]], horizon: int
                  ) -> List[OpTrace]:
    """Interval analysis: which carried integers wrap within ``horizon``
    calls. Returns the second evaluation's traces.

    phases: the call's argument tuples, one per host-side branch (a tick in
        which the periodic controller runs and one in which it does not);
        the outputs of all phases are unioned.
    names: the name of each argument (leaf names are paths under them).
    input_ivals: declared ranges of input leaves by name (hotness caps,
        footprints); every other non-carried leaf reads as its values.
    carry: (argument index, result index) of the carried state, or None.

    The carried state seeds at its concrete values. For each carried
    integer leaf the per-tick growth ``g = out.hi - in.hi`` is
    extrapolated: unsafe when ``out.hi + g * (horizon - 1)`` exceeds the
    leaf's dtype range. Events (casts that can wrap, integers past 2^24
    cast to float32) surface as findings; ops the shadow does not model
    are recorded as notes, never silently ignored.
    """
    cname = names[carry[0]] if carry is not None else None
    seeds: Dict[str, Interval] = dict(input_ivals)
    carried: Dict[str, torch.Tensor] = {}
    if carry is not None:
        carried = dict(named_leaves(phases[0][carry[0]], cname))
        for leaf, t in carried.items():
            seeds[leaf] = value_interval(t)

    def evaluate(seed_map):
        ctxs, traces, outs = [], [], {}
        for args in phases:
            ctx = EvalContext()
            tr = _seeded_record(fn, args, names, seed_map, ctx)
            ctxs.append(ctx)
            traces.append(tr)
            if carry is not None:
                for leaf, iv in _carried_out(tr, carry, cname).items():
                    outs[leaf] = iv if leaf not in outs else outs[leaf].union(iv)
        return ctxs, traces, outs

    ctxs1, _, outs1 = evaluate(seeds)
    # Second evaluation with each carry widened by its first-tick output:
    # a transient jump (tier -1 -> 1, a saturated gather) settles — its
    # second-iteration growth is zero — while a genuine cumulative counter
    # keeps the same per-tick rate. Only *persistent* growth extrapolates.
    seeds2 = dict(seeds)
    for leaf in carried:
        if leaf in outs1:
            seeds2[leaf] = seeds[leaf].union(outs1[leaf])
    _, traces2, outs2 = evaluate(seeds2)

    for leaf, t in carried.items():
        if t.dtype.is_floating_point or t.dtype == torch.bool \
                or leaf not in outs1:
            continue
        o1, o2 = outs1[leaf], outs2[leaf]
        grow = max(o2.hi - o1.hi, 0.0)
        drop = min(o2.lo - o1.lo, 0.0)
        top = dtype_interval(t.dtype)
        if grow == 0.0 and drop == 0.0:
            continue
        hi_h = o1.hi + grow * (horizon - 1)
        lo_h = o1.lo + drop * (horizon - 1)
        if hi_h > top.hi or lo_h < top.lo:
            rate = grow if hi_h > top.hi else -drop
            safe = int((top.hi - o1.hi) // grow) if hi_h > top.hi else \
                int((o1.lo - top.lo) // max(-drop, 1.0))
            report.add(Finding(
                "overflow", target, f"carry:{leaf}",
                f"carried counter `{leaf}` ({dtype_name(t.dtype)}) grows up "
                f"to {rate:g}/tick; wraps after ~{safe} ticks (< declared "
                f"horizon {horizon}) — widen the accumulator or re-window "
                f"it at the chunk boundary"))

    events, unknown = {}, {}
    for ctx in ctxs1:
        for ev in ctx.events:
            events.setdefault(ev.slug, ev)
        for op, n in ctx.unknown_ops.items():
            unknown[op] = max(unknown.get(op, 0), n)
    for slug, ev in sorted(events.items()):
        if ev.kind == "cast-unbounded":
            # over-approximation (no finite bound survived to the cast):
            # informative, not gated
            report.note(f"overflow/{target}: {slug}: {ev.detail}")
        else:
            report.add(Finding("overflow", target, slug, ev.detail))
    for op, n in sorted(unknown.items()):
        report.note(f"overflow/{target}: op `{op}` (x{n}) not modelled; "
                    f"outputs widened to dtype range")
    return traces2


# ------------------------------------------------------------- donation ----
def donation_pass(fn: Callable, args: tuple, donate_argnums: Sequence[int],
                  target: str, report: Report) -> None:
    """Donated inputs must be updated in place: every leaf of a donated
    argument shares its storage with a leaf of the result (torch's
    counterpart of an input/output alias), at the same address."""
    ptrs = {i: [t.untyped_storage().data_ptr()
                for _, t in named_leaves(args[i], "")]
            for i in donate_argnums}
    out = {t.untyped_storage().data_ptr()
           for _, t in named_leaves(fn(*args), "")}
    for argnum in donate_argnums:
        for k, (_, t) in enumerate(named_leaves(args[argnum], "")):
            if (t.untyped_storage().data_ptr() != ptrs[argnum][k]
                    or ptrs[argnum][k] not in out):
                report.add(Finding(
                    "donation", target, f"unmatched:arg{argnum}:leaf{k}",
                    f"donated arg {argnum} leaf {k} "
                    f"{tuple(t.shape)} {dtype_name(t.dtype)} is not "
                    f"updated in place — the call allocates a new buffer "
                    f"and the rollout double-buffers"))


def _tree_bytes(tree) -> int:
    """The bytes of every tensor leaf (a leaf held twice counts twice: the
    state's logical size, whatever it aliases)."""
    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree, ""))


def steady_memory_pass(step: Callable, state, calls: int, target: str,
                       report: Report) -> List[int]:
    """``state = step(state)`` ``calls`` times: the state's bytes and, on
    the card, ``torch.cuda.memory_allocated()`` must never exceed their
    values after the second call (the first may build caches). Not
    "equal": leaves of a functional state may come to share a storage
    (the fleet's ``det.win_resident`` and ``det.active_last`` are one
    tensor on some ticks), and each 4-byte storage fewer frees one
    512-byte block of the caching allocator. Returns the readings (bytes
    of allocated device memory on the card, else of the state)."""
    cuda = any(t.is_cuda for _, t in named_leaves(state, ""))
    sizes, alloc = [], []
    for _ in range(calls):
        state = step(state)
        sizes.append(_tree_bytes(state))
        if cuda:
            torch.cuda.synchronize()
            alloc.append(torch.cuda.memory_allocated())
    for slug, vals in (("growth:state-bytes", sizes),
                       ("growth:memory_allocated", alloc)):
        if len(vals) > 2 and max(vals[2:]) > vals[1]:
            report.add(Finding(
                "donation", target, slug,
                f"{slug.split(':')[1]} after each call: {vals} — the "
                f"rollout's memory grows with its length"))
    return alloc or sizes


# --------------------------------------------------------------- launch ----
def launch_pass(trace: OpTrace, wrapper: str, target: str,
                report: Report) -> None:
    """A kernel wrapper handed CUDA tensors must launch its kernel."""
    if trace.launches.get(wrapper, 0) == 0:
        report.add(Finding(
            "launch", target, f"no-launch:{wrapper}",
            f"`{wrapper}` ran on the card without launching its kernel "
            f"(launches delta 0)"))


# -------------------------------------------------------------- capture ----
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


CAPTURE_PHASES = ("tick", "controller")   # the target's phases, in order
CAPTURE_REPS = 20                          # timed calls of each kind


def start_capture_probe() -> subprocess.Popen:
    """Start the capture probe of the kernel-backed tick at C1's size in a
    child process (see ``capture_child``); read its verdict with
    ``capture_verdict``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    code = ("from repro_torch.analysis.op_audit import capture_child; "
            "capture_child()")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def capture_verdict(proc: subprocess.Popen, timeout: float = 300.0) -> dict:
    """The child's verdict: {"target", "phases": [{"phase", "ok", "where",
    "error", "replay_ms", "eager_ms"}, ...]}."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        err = f"capture probe timed out after {timeout:g} s"
    for line in out.splitlines():
        if line.startswith("CAPTURE "):
            return json.loads(line[len("CAPTURE "):])
    return {"target": None, "phases": [{
        "phase": "child", "ok": False, "where": "<child>",
        "error": f"capture probe exited {proc.returncode}: "
                 f"{err.strip()[-400:]}"}]}


def _median_ms(call: Callable[[], object], reps: int) -> float:
    """Median wall time of ``call()`` followed by a device synchronise."""
    import time
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def _capture_phase(fn: Callable, args: tuple, label: str) -> dict:
    """Capture one call of ``fn(*args)`` in a CUDA graph and replay it."""
    import traceback
    verdict = {"phase": label, "ok": True, "where": None, "error": ""}
    try:
        want = named_leaves(fn(*args), "out")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = named_leaves(fn(*args), "out")
        graph.replay()
        torch.cuda.synchronize()
        # warm medians: the eager tick (host dispatch of every op
        # included) beside the replay of the same work
        verdict["eager_ms"] = _median_ms(lambda: fn(*args), CAPTURE_REPS)
        verdict["replay_ms"] = _median_ms(graph.replay, CAPTURE_REPS)
        for (name, a), (_, b) in zip(got, want):
            same = (torch.equal(a, b) if not a.is_floating_point()
                    else torch.allclose(a, b, rtol=1e-6, atol=0.0))
            if not same:
                verdict.update(ok=False, where="replay",
                               error=f"replayed {name} differs from eager")
                break
    except Exception as e:    # the verdict is the probe's result
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename.startswith(os.path.join(_SRC, "repro_torch"))
                  and "analysis" not in f.filename]
        where = "<top>"
        if frames:
            f = frames[-1]
            rel = os.path.relpath(f.filename, os.path.join(_SRC,
                                                           "repro_torch"))
            where = f"{rel.replace(os.sep, '/')}:{f.name}"
        verdict.update(ok=False, where=where,
                       error=f"{type(e).__name__}: {e}"[:600])
    return verdict


def capture_child() -> None:
    """Child-process body: build the kernel-backed tick at C1's size
    (``c1_tick_target`` at T = 64) on the card and, for each controller
    phase (the tick without and the tick with the controller: a host-side
    branch, so one graph each), warm it on a side stream, capture one call
    with ``torch.cuda.graph``, time ``CAPTURE_REPS`` warm eager calls and
    as many replays (medians), and hold the replay's integer and bool
    leaves bitwise (floats within 1e-6) against an eager call on the same
    arguments. Prints one line, ``CAPTURE {json}``."""
    from repro_torch.analysis.targets import C1, c1_tick_target
    t = c1_tick_target(C1["T"][-1], "cuda")
    print("CAPTURE " + json.dumps({"target": t.name, "phases": [
        _capture_phase(t.fn, args, label)
        for args, label in zip(t.phases, CAPTURE_PHASES)]}), flush=True)
