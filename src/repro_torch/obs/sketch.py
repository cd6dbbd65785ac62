"""Fixed-size mergeable quantile sketch for streaming fleet percentiles
(torch port of ``repro/obs/sketch.py``).

A histogram of ``SKETCH_BUCKETS`` int32 counters per host, updated with one
scatter-add inside the tick and merged across hosts by plain addition:

  * ``N_LINEAR`` exact unit buckets for values ``0 .. N_LINEAR-1``;
  * ``N_LOG`` log2-subdivided buckets beyond (``LOG_SUB`` per octave) up to
    ``N_LINEAR * 2^(N_LOG / LOG_SUB)``; larger values clamp into the last
    bucket.

``sketch_bucket`` places a value by the sketch's own edges
(``sketch_edges``): bucket b holds ``[edges[b], edges[b + 1])``. The
reference computes the log buckets through a float32 ``log2`` that is one
ulp low at 256, 512, 8192 and 32768 under XLA and puts those values one
bucket low; the port does not copy that (pinned by
``tests/test_torch_attribution.py``). The host side (edges, merge,
percentiles) is numpy, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device, to_host

N_LINEAR = 128          # exact unit buckets: values 0..127
LOG_SUB = 4             # log2 sub-buckets per octave beyond the linear range
N_LOG = 36              # covers N_LINEAR * 2^(36/4) = 65536 before clamping
SKETCH_BUCKETS = N_LINEAR + N_LOG


def init_sketch(batch_shape: Sequence[int] = (), device="cuda"
                ) -> torch.Tensor:
    """Zero sketch counts, optionally with leading batch axes ([H] hosts)."""
    return torch.zeros(tuple(batch_shape) + (SKETCH_BUCKETS,),
                       dtype=torch.int32, device=resolve_device(device))


def sketch_edges() -> np.ndarray:
    """Host-side: inclusive lower edge of each bucket, [SKETCH_BUCKETS + 1]
    (the trailing entry is the exclusive top of the covered range)."""
    lin = np.arange(N_LINEAR, dtype=np.float64)
    log = N_LINEAR * 2.0 ** (np.arange(N_LOG + 1, dtype=np.float64) / LOG_SUB)
    return np.concatenate([lin, log])


def sketch_bucket(values: torch.Tensor) -> torch.Tensor:
    """int64 bucket index of each value: the last bucket whose lower edge is
    <= the value. Negative values clamp to bucket 0, huge values to the
    last bucket."""
    edges = _edges_on(values.device)
    v = torch.clamp(values.to(torch.float64), min=0.0)
    b = torch.searchsorted(edges, v, right=True) - 1
    return torch.clamp(b, 0, SKETCH_BUCKETS - 1)


_EDGES: dict = {}


def _edges_on(device: torch.device) -> torch.Tensor:
    """The buckets' float64 lower edges on ``device``, copied there once."""
    key = str(device)
    if key not in _EDGES:
        _EDGES[key] = torch.as_tensor(sketch_edges()[:SKETCH_BUCKETS],
                                      device=device)
    return _EDGES[key]


def sketch_add(counts: torch.Tensor, values: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold ``values`` (any shape) into a [SKETCH_BUCKETS] sketch: one int32
    ``index_add_`` (integer adds, so the order of duplicates is moot)."""
    b = sketch_bucket(values).reshape(-1)
    w = (torch.ones_like(b, dtype=torch.int32) if weights is None
         else weights.reshape(-1).to(torch.int32))
    return counts.clone().index_add_(0, b, w)


def sketch_merge(counts) -> np.ndarray:
    """Merge sketches by summing every leading axis: [..., NB] -> [NB]."""
    c = to_host(counts).astype(np.int64)
    return c.reshape(-1, c.shape[-1]).sum(axis=0)


def sketch_count(counts) -> int:
    return int(to_host(counts).astype(np.int64).sum())


def sketch_percentile(counts, q: float) -> float:
    """The ``hist_percentile`` spec on sketch geometry: lower edge of the
    first bucket where cumulative mass >= q * total; empty -> 0.0."""
    c = sketch_merge(counts)
    cum = np.cumsum(c)
    total = cum[-1]
    if total == 0:
        return 0.0
    idx = int(np.argmax(cum >= q * total))
    return float(sketch_edges()[idx])


def sketch_percentiles(counts, qs: Sequence[float]) -> np.ndarray:
    c = sketch_merge(counts)   # merge once for many quantiles
    return np.array([sketch_percentile(c, q) for q in qs])
