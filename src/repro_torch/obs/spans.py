"""Spans at the port's layer boundaries: the host time of each and, on a
CUDA device, its device time, read from a pair of CUDA events recorded on
the current stream.

    from repro_torch.obs import spans
    with spans.span("serve.tiering"):
        ...

Off, the default, ``span`` tests one flag and returns one shared context
that does nothing: it allocates nothing, records no event and opens no
profiler range. ``enable()`` switches the recorder on. Then a span opened
while no other is open starts a step (``serve.step``, ``prefill.step``,
``train.step``), and every span opened inside it records its parent and
shares the step's id. A step opened while a torch profiler runs is
``profiled``: its spans record no events, and each opens
``torch.profiler.record_function("eq." + name)``, so that the spans lie in
the profiler's host timeline, on its own clock, where they name the host
work around each device gap. ``summary()`` reports the unprofiled steps.

The recorder never synchronises. A span's events are read with ``query()``
when a later step opens, and finally by ``summary()``, after the caller has
synchronised the device. A span's device time is the stream's time between
its two events: the device work the span enqueued, and any idle time the
host left between that work. The recorder does nothing while a stream is
being captured into a CUDA graph, on any thread but the one that opened the
step, and inside autograd's backward pass, whose recomputation of
rematerialised forwards (on autograd's device thread on a card, on the
caller's thread on the CPU) the enclosing ``train.backward`` holds.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

PREFIX = "eq."                # the profiler ranges' prefix

_on = False


class _Off:
    """The shared context of a span that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Record:
    __slots__ = ("name", "parent", "step", "profiled", "t0", "t1", "events",
                 "device_ms")

    def __init__(self, name: str, parent: Optional[int], step: int,
                 profiled: bool):
        self.name, self.parent, self.step = name, parent, step
        self.profiled = profiled
        self.t0 = self.t1 = None          # host perf_counter_ns
        self.events = None                # (start, end) CUDA events
        self.device_ms: Optional[float] = None


class _Recorder:
    """What the spans of one process recorded."""

    def __init__(self):
        self.records: List[_Record] = []
        self.open: List[int] = []         # the open spans (record indices)
        self.pending: List[_Record] = []  # closed, events unread, closing order
        self.pool: List[torch.cuda.Event] = []   # free CUDA events
        self.owner: Optional[int] = None  # the thread that opened the step
        self.steps = 0
        self.profiled = False             # the open step's
        self.cuda = False                 # the open step's: CUDA is initialised

    def event(self) -> torch.cuda.Event:
        return self.pool.pop() if self.pool else torch.cuda.Event(
            enable_timing=True)

    def resolve(self) -> None:
        """Read the events of the closed spans whose end the device has
        passed, and put the events back in the pool."""
        done = 0
        for r in self.pending:
            start, end = r.events
            if not end.query():
                break                     # later ends come later on the stream
            r.device_ms = start.elapsed_time(end)
            self.pool += r.events
            r.events = None
            done += 1
        del self.pending[:done]


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "rec", "index", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        rec = self.rec = _REC
        if not rec.open:                  # a step opens
            rec.resolve()
            rec.steps += 1
            rec.owner = threading.get_ident()
            rec.profiled = torch.autograd._profiler_enabled()
            rec.cuda = torch.cuda.is_initialized()
        r = _Record(self.name, rec.open[-1] if rec.open else None, rec.steps,
                    rec.profiled)
        self.index = len(rec.records)
        rec.records.append(r)
        rec.open.append(self.index)
        r.t0 = time.perf_counter_ns()
        if r.profiled:
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        elif rec.cuda:
            r.events = (rec.event(), rec.event())
            r.events[0].record()
        return None

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = self.rec
        if rec is not _REC:
            return False                  # reset() ran while the span was open
        r = rec.records[self.index]
        if r.events is not None:
            r.events[1].record()
            rec.pending.append(r)
        r.t1 = time.perf_counter_ns()
        rec.open.pop()
        return False


def span(name: str):
    """A context that records the span ``name`` while the recorder is on,
    and does nothing while it is off."""
    if not _on:
        return _OFF
    rec = _REC
    if rec.open and threading.get_ident() != rec.owner:
        return _OFF
    if torch._C._current_graph_task_id() != -1:     # inside a backward pass
        return _OFF
    if torch.cuda.is_initialized() and \
            torch.cuda.is_current_stream_capturing():
        return _OFF
    return _Span(name)


def enable() -> None:
    """Record the spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Record no span from now on; what was recorded stays."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span recorded, and the steps."""
    global _REC
    _REC = _Recorder()


def summary() -> Dict[str, dict]:
    """Each span name over the unprofiled steps: ``steps`` (the steps it ran
    in), ``calls``, and per step ``host_ms``, ``device_ms`` and
    ``self_device_ms`` (its device time less its children's). The device
    numbers are None where a call has no device time (the CPU). Call it
    after synchronising the device."""
    rec = _REC
    rec.resolve()
    if rec.pending:
        raise RuntimeError("spans.summary(): the device has not reached every "
                           "span's end; synchronise it first")
    kept = [(i, r) for i, r in enumerate(rec.records)
            if r.t1 is not None and not r.profiled]
    children: Dict[int, float] = {}
    for _, r in kept:
        if r.parent is not None and r.device_ms is not None:
            children[r.parent] = children.get(r.parent, 0.0) + r.device_ms
    rows: Dict[str, dict] = {}
    for i, r in kept:
        row = rows.setdefault(r.name, {"steps": set(), "calls": 0,
                                       "host": 0.0, "device": 0.0,
                                       "self": 0.0, "timed": True})
        row["steps"].add(r.step)
        row["calls"] += 1
        row["host"] += (r.t1 - r.t0) / 1e6
        if r.device_ms is None:
            row["timed"] = False
        else:
            row["device"] += r.device_ms
            row["self"] += r.device_ms - children.get(i, 0.0)
    out = {}
    for name, row in rows.items():
        n = len(row["steps"])
        timed = row["timed"]
        out[name] = {"steps": n, "calls": row["calls"],
                     "host_ms": row["host"] / n,
                     "device_ms": row["device"] / n if timed else None,
                     "self_device_ms": row["self"] / n if timed else None}
    return out
