"""Plain torch versions of the selection-core kernels (one to one with
``repro/kernels/select/ref.py``).

Semantics shared with the CUDA kernels:

* ``seg_topk``: lane j of row t holds that row's j-th best eligible column
  by (score desc, column asc) — the ``jax.lax.top_k`` "lower index wins"
  tie-break. Eligible means ``valid & isfinite(score)``. Lanes at or beyond
  ``min(quota[t], k)`` (or beyond the row's eligible count) carry the
  sentinel column ``S`` and ``take=False``.
* ``seg_reduce``: per-row sum and exclusive prefix sum of the masked int32
  values (wrapping on overflow).
* ``seg_sums``: the per-row sum alone.
"""
from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, ties to
    the lower index. ``torch.topk`` makes no promise on tie order, so this is
    a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def seg_topk_ref(score: torch.Tensor, valid: torch.Tensor,
                 quotas: torch.Tensor, k: int):
    """score f32 [T, S], valid bool [T, S], quotas int32 [T], k <= S.
    Returns (cols [T, k] int32, take [T, k] bool, counts [T] int32)."""
    S = score.shape[1]
    elig = valid & torch.isfinite(score)
    s = torch.where(elig, score, float("-inf"))
    vals, cols = top_k(s, k)
    lane = torch.arange(k, dtype=torch.int32, device=score.device)
    take = (lane[None, :] < quotas.to(torch.int32)[:, None]) \
        & (vals > float("-inf"))
    cols = torch.where(take, cols, S).to(torch.int32)
    return cols, take, take.sum(dim=1, dtype=torch.int32)


def seg_reduce_ref(x: torch.Tensor, valid: torch.Tensor):
    """x int32 [T, S], valid bool [T, S]. Returns (sums [T] int32,
    prefix [T, S] int32 exclusive prefix sum along axis 1)."""
    xm = torch.where(valid, x, 0).to(torch.int32)
    cs = torch.cumsum(xm, dim=1, dtype=torch.int32)
    return cs[:, -1], cs - xm


def seg_sums_ref(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sum-only variant of ``seg_reduce_ref`` (no prefix output)."""
    return torch.where(valid, x, 0).to(torch.int32).sum(dim=1,
                                                         dtype=torch.int32)
