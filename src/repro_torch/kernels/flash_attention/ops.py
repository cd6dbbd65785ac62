"""Wrapper of the flash-attention kernel.

``flash_attention`` sends CUDA tensors to the hand-written kernel and CPU
tensors to the plain version; ``impl="ref"`` calls the plain version on
any device. Launches are counted in ``flash_attention.launches``, and by
the kernel they took in ``flash_attention.routes`` (``"wgmma"``,
``"tf32x3"``; the launcher's own count, reset in place).

On a CUDA tensor the kernel runs inside a ``torch.autograd.Function``
(``FlashAttention``), and nowhere else: its forward launches the kernel;
its backward is the gradient of the plain version (``flash_attention_ref``,
recomputed from the saved q, k and v under ``torch.enable_grad``, then
``torch.autograd.grad`` against the incoming gradient). The reference
never differentiates its Pallas kernel: its training forward is plain
``jnp`` attention, so the plain version's gradient is the reference's own
backward, not a fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R

IMPLS = ("cuda", "ref")


class FlashAttention(torch.autograd.Function):
    """K7 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        flash_attention.launches += 1
        return K.flash_attention_cuda(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = R.flash_attention_ref(*inputs, causal=ctx.causal,
                                        window=ctx.window)
            got = iter(torch.autograd.grad(out, wrt, grad))
        return (*(next(got) if t.requires_grad else None for t in inputs),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "cuda") -> torch.Tensor:
    """Attention over [B, H|K, S, D] tensors (GQA, causal / sliding window,
    queries right-aligned to the keys). Returns [B, H, Sq, D] in q's
    dtype."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "cuda" and q.is_cuda:
        return FlashAttention.apply(q, k, v, causal, window)
    return R.flash_attention_ref(q, k, v, causal=causal, window=window)


flash_attention.launches = 0
flash_attention.routes = K.flash_attention_cuda.routes
