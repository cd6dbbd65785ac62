"""Launchers of the selection-core CUDA kernels (``csrc/selection.cu``).

Each function validates its CUDA inputs, allocates the outputs, launches
on PyTorch's current stream and raises on a launch error. No
synchronisation, no fallback.

* ``seg_topk_cuda`` replaces ``repro/kernels/select/kernel.py``
  ``seg_topk_tpu``: one block per tenant row, ``min(quota, k)`` rounds of a
  block-wide argmax over packed (score, column) keys.
* ``seg_reduce_cuda`` replaces ``seg_reduce_tpu``: one block per row, a
  chunked warp-shuffle scan with a running carry.
* ``seg_sums_cuda`` replaces ``seg_sums_tpu``: one block per row, a
  warp-shuffle reduction.

All three are bound by device-memory bytes (a few integer operations per
byte read).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_cuda, load_library, stream_of


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
    with torch.cuda.device(dev):
        load_library().call("seg_topk_launch", score.data_ptr(),
                            valid.data_ptr(), quotas.data_ptr(), T, S, k,
                            cols.data_ptr(), take.data_ptr(),
                            counts.data_ptr(), stream_of(score))
    return cols, take, counts


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
