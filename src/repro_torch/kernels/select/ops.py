"""Wrappers of the selection-core kernels.

A CUDA tensor goes to the hand-written kernel (``kernel.py``); a CPU tensor
goes to the plain version (``ref.py``), because the kernel cannot run
there. Nothing else selects between the two, and a kernel error raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.select import kernel as K
from repro_torch.kernels.select import ref as R


def seg_topk(score: torch.Tensor, valid: torch.Tensor, quotas: torch.Tensor,
             k: int):
    """Per-row quota-bounded top-k. score/valid: [T, S]; quotas: [T].
    Returns (cols [T, k'] int32 — sentinel S on non-taken lanes,
    take [T, k'] bool, counts [T] int32) with k' = max(min(k, S), 1)."""
    S = score.shape[1]
    k = max(min(k, S), 1)
    score = score.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    quotas = quotas.to(torch.int32).contiguous()
    if score.is_cuda:
        seg_topk.launches += 1
        return K.seg_topk_cuda(score, valid, quotas, k)
    return R.seg_topk_ref(score, valid, quotas, k)


def seg_reduce(x: torch.Tensor, valid: torch.Tensor):
    """Fused per-row sum + exclusive prefix sum (integers only).
    x/valid: [T, S]. Returns (sums [T] int32, prefix [T, S] int32)."""
    x = x.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    if x.is_cuda:
        seg_reduce.launches += 1
        return K.seg_reduce_cuda(x, valid)
    return R.seg_reduce_ref(x, valid)


def seg_sums(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-row masked sum (integers only). x/valid: [T, S] -> [T] int32."""
    x = x.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    if x.is_cuda:
        seg_sums.launches += 1
        return K.seg_sums_cuda(x, valid)
    return R.seg_sums_ref(x, valid)


seg_topk.launches = 0
seg_reduce.launches = 0
seg_sums.launches = 0
