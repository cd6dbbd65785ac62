"""Wrapper of the Mamba2 SSD scan kernel.

``ssd_scan`` sends CUDA tensors to the hand-written kernel and CPU tensors
to the plain version; ``impl="ref"`` calls the plain version on any
device. Launches are counted in ``ssd_scan.launches``.

On a CUDA tensor the kernel runs inside a ``torch.autograd.Function``
(``SSDScan``), and nowhere else: its forward launches the kernel; its
backward is the gradient of the plain version (``ssd_scan_ref``,
recomputed from the saved x, a, b and c under ``torch.enable_grad``, then
``torch.autograd.grad`` against the gradients of both outputs, y and
h_final; an unused h_final's gradient is materialised as zeros). The
reference never differentiates its Pallas kernel: its training forward is
the plain chunked SSD, so the plain version's gradient is the reference's
own backward, not a fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref as R

IMPLS = ("cuda", "ref")


class SSDScan(torch.autograd.Function):
    """K8 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk: int):
        ctx.save_for_backward(x, a, b, c)
        ctx.chunk = chunk
        ctx.set_materialize_grads(True)
        ssd_scan.launches += 1
        y, h = K.ssd_scan_cuda(x, a, b, c, chunk)
        return y.to(x.dtype), h

    @staticmethod
    def backward(ctx, gy, gh):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:4])]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y, h = R.ssd_scan_ref(*inputs, ctx.chunk)
            got = iter(torch.autograd.grad((y, h), wrt, (gy, gh)))
        return (*(next(got) if t.requires_grad else None for t in inputs),
                None)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int, impl: str = "cuda"):
    """Mamba2 SSD. x: [B,S,H,P] float32 (dt-scaled); a: [B,S,H] float32
    log-decay; b, c: [B,S,G,N] per group. Returns (y [B,S,H,P] in x's
    dtype, h_final [B,H,P,N] float32)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if x.shape[1] % chunk:
        raise ValueError(f"ssd_scan: S={x.shape[1]} is not a multiple of "
                         f"the chunk {chunk}")
    if impl == "cuda" and x.is_cuda:
        return SSDScan.apply(x, a, b, c, chunk)
    return R.ssd_scan_ref(x, a, b, c, chunk)


ssd_scan.launches = 0
