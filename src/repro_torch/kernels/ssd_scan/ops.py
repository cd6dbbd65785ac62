"""Wrapper of the Mamba2 SSD scan kernel.

``ssd_scan`` sends CUDA tensors to the hand-written kernel and CPU tensors
to the plain version; ``impl="ref"`` calls the plain version on any
device. Launches are counted in ``ssd_scan.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref as R

IMPLS = ("cuda", "ref")


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
        ssd_scan.launches += 1
        y, h = K.ssd_scan_cuda(x, a, b, c, chunk)
        return y.to(x.dtype), h
    return R.ssd_scan_ref(x, a, b, c, chunk)


ssd_scan.launches = 0
