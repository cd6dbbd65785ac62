"""Wrapper of the flash-attention kernel.

``flash_attention`` sends CUDA tensors to the hand-written kernel and CPU
tensors to the plain version; ``impl="ref"`` calls the plain version on
any device. Launches are counted in ``flash_attention.launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R

IMPLS = ("cuda", "ref")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "cuda") -> torch.Tensor:
    """Attention over [B, H|K, S, D] tensors (GQA, causal / sliding window,
    queries right-aligned to the keys). Returns [B, H, Sq, D] in q's
    dtype."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "cuda" and q.is_cuda:
        flash_attention.launches += 1
        return K.flash_attention_cuda(q, k, v, causal=causal, window=window)
    return R.flash_attention_ref(q, k, v, causal=causal, window=window)


flash_attention.launches = 0
