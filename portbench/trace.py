"""Device traces of chosen spans of a run (``torch.profiler``), reduced to
what the per-layer metrics read: device busy time as the union of the
device intervals, kernel time and launches by name, and the idle gaps
between device work, each named by the host operation that was running
in its middle.

Only the spans a path chooses are profiled, each on its own, so the trace
of a long window stays small; each span ends in a synchronisation, so its
wall time covers its device work.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

GAPS_LABELLED = 64       # longest idle gaps of a span that get a host label
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class Span:
    label: str
    wall_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]      # name -> (seconds, launches)
    gaps: Dict[str, float]                     # host op -> idle seconds
    info: dict = field(default_factory=dict)   # what the path noted

    @property
    def launches(self) -> int:
        return sum(n for k, (_, n) in self.kernels.items()
                   if not k.startswith(NOT_KERNELS))

    def kernel_s(self, *names: str) -> float:
        """Seconds of the kernels whose name contains one of ``names``."""
        return sum(s for k, (s, _) in self.kernels.items()
                   if any(n in k for n in names))


class Tracer:
    """Profiles the spans a path marks when ``enabled``; otherwise its
    spans do nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: List[Span] = []

    def warm(self) -> None:
        """Start the profiler once, untimed, so the first traced span does
        not pay its start-up."""
        if self.enabled:
            with self.span("warm"):
                pass
            self.spans.clear()

    @contextlib.contextmanager
    def span(self, label: str, on: bool = True, **info):
        if not (self.enabled and on):
            yield None
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield info
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        self.spans.append(reduce(prof, label, wall, info))

    # ------------------------------------------------------ summaries ----
    def busy_s(self) -> float:
        return sum(s.busy_s for s in self.spans)

    def window_s(self) -> float:
        return sum(s.wall_s for s in self.spans)

    def breakdown(self, n: int = 10) -> dict:
        ops: Dict[str, float] = {}
        gaps: Dict[str, float] = {}
        for s in self.spans:
            for k, (sec, _) in s.kernels.items():
                ops[k] = ops.get(k, 0.0) + sec
            for k, sec in s.gaps.items():
                gaps[k] = gaps.get(k, 0.0) + sec

        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def reduce(prof, label: str, wall: float, info: dict) -> Span:
    """One profiled span's device intervals and host ops, reduced."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end, e.name)
        (dev if e.device_type == DeviceType.CUDA else host).append(rng)
    dev.sort()
    kernels: Dict[str, Tuple[float, int]] = {}
    busy, end = 0.0, None
    idle = []                                  # (length us, middle us)
    for s, e, name in dev:
        if end is not None and s > end:
            idle.append((s - end, (s + end) / 2))
        busy += max(0.0, e - (s if end is None else max(s, end)))
        end = e if end is None else max(end, e)
        sec, cnt = kernels.get(name, (0.0, 0))
        kernels[name] = (sec + (e - s) / 1e6, cnt + 1)
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    for length, mid in sorted(idle, reverse=True)[:GAPS_LABELLED]:
        name = "no host op"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:                          # the innermost op holding mid
            if host[i][1] >= mid:
                name = host[i][2]
                break
            i -= 1
        gaps[name] = gaps.get(name, 0.0) + length / 1e6
    return Span(label, wall, busy / 1e6, kernels, gaps, dict(info))
