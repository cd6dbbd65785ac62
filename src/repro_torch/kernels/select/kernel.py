"""Launchers of the selection-core CUDA kernels (``csrc/selection.cu``).

Each function validates its CUDA inputs, allocates the outputs, launches
on PyTorch's current stream and raises on a launch error. No
synchronisation, no fallback.

* ``seg_topk_cuda`` replaces ``repro/kernels/select/kernel.py``
  ``seg_topk_tpu``, over packed (score, column) keys, unique by their
  column, in one of two routes, which the launcher reports and
  ``seg_topk_cuda.routes`` counts. ``"staged"`` (S <= 24,576, C1's rows):
  one block per tenant row with the row's keys in shared memory; a radix
  select (8-bit digits, most significant first, stopping once the prefix
  holds only winners) finds the r-th largest key, and the r winners (the
  keys at or above it) are compacted and bitonic-sorted in shared memory,
  up to 2,048 at a time by rank. ``"long"`` (the dynamic rowspace, S = L):
  a thread-block cluster per row reads the row once in 16-byte vectors
  (scores only behind valid lanes) into a 12-bit first-digit histogram
  summed through distributed shared memory; the keys at or above the
  r-th key's bin go to the leader block, which finishes the select and the
  sort there; further digits over the row keep it exact when they
  overflow its buffer. A row whose quota is <= 0 is not read.
* ``seg_reduce_cuda`` replaces ``seg_reduce_tpu``: one block of 1,024
  threads per row, one scan. Each thread owns a run of 4-lane units (one
  at S=4,096), issues its 16-byte loads of x and 4-byte loads of valid
  before its first add; one block exclusive scan of the run totals (one
  barrier) gives each run its first prefix, written back as 16-byte
  stores where the prefix row is aligned like x.
* ``seg_sums_cuda`` replaces ``seg_sums_tpu``: one block of 1,024 threads
  per row, 16-byte loads of x beside 4-byte loads of the matching valid
  bytes, up to four of each in flight per thread before the first add,
  and one barrier.

All three are bound by device-memory bytes (a few integer operations per
byte read).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_cuda, load_library, stream_of

# seg_topk's routes, by the code its launcher reports
TOPK_ROUTES = {0: "staged", 1: "long"}


def seg_topk_cuda(score: torch.Tensor, valid: torch.Tensor,
                  quotas: torch.Tensor, k: int):
    """score f32 [T, S], valid bool [T, S], quotas int32 [T], 1 <= k <= S."""
    check_cuda(score, torch.float32, 2, "score")
    check_cuda(valid, torch.bool, 2, "valid")
    check_cuda(quotas, torch.int32, 1, "quotas")
    T, S = score.shape
    if valid.shape != score.shape or quotas.shape[0] != T or not 1 <= k <= S:
        raise ValueError(f"seg_topk: bad shapes score {tuple(score.shape)} "
                         f"valid {tuple(valid.shape)} quotas "
                         f"{tuple(quotas.shape)} k={k}")
    dev = score.device
    cols = torch.empty((T, k), dtype=torch.int32, device=dev)
    take = torch.empty((T, k), dtype=torch.bool, device=dev)
    counts = torch.empty((T,), dtype=torch.int32, device=dev)
    route = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        load_library().call("seg_topk_launch", score.data_ptr(),
                            valid.data_ptr(), quotas.data_ptr(), T, S, k,
                            cols.data_ptr(), take.data_ptr(),
                            counts.data_ptr(), ctypes.byref(route),
                            stream_of(score))
    seg_topk_cuda.routes[TOPK_ROUTES[route.value]] += 1
    return cols, take, counts


seg_topk_cuda.routes = {name: 0 for name in TOPK_ROUTES.values()}


def _check_rows(x: torch.Tensor, valid: torch.Tensor, name: str) -> None:
    check_cuda(x, torch.int32, 2, "x")
    check_cuda(valid, torch.bool, 2, "valid")
    if valid.shape != x.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs valid "
                         f"{tuple(valid.shape)}")


def seg_reduce_cuda(x: torch.Tensor, valid: torch.Tensor):
    """x int32 [T, S], valid bool [T, S] -> (sums [T], prefix [T, S])."""
    _check_rows(x, valid, "seg_reduce")
    T, S = x.shape
    sums = torch.empty((T,), dtype=torch.int32, device=x.device)
    prefix = torch.empty((T, S), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        load_library().call("seg_reduce_launch", x.data_ptr(),
                            valid.data_ptr(), T, S, sums.data_ptr(),
                            prefix.data_ptr(), stream_of(x))
    return sums, prefix


def seg_sums_cuda(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """x int32 [T, S], valid bool [T, S] -> sums [T]."""
    _check_rows(x, valid, "seg_sums")
    T, S = x.shape
    sums = torch.empty((T,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        load_library().call("seg_sums_launch", x.data_ptr(),
                            valid.data_ptr(), T, S, sums.data_ptr(),
                            stream_of(x))
    return sums
