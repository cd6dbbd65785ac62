"""Wrapper of the Mamba2 decode-state kernel.

``ssd_decode`` sends CUDA tensors to the hand-written kernel under
``impl="cuda"``: it updates the state in place and returns that same
tensor. CPU tensors, and ``impl="ref"`` on any device, go to the plain
version, which returns a new state; so callers use the returned state.
Both routes refuse the same arguments (``kernel.check_inputs``), before
any launch. Launches are counted in ``ssd_decode.launches``.
"""
from __future__ import annotations

from repro_torch.kernels.ssd_decode import kernel as K
from repro_torch.kernels.ssd_decode import ref as R

IMPLS = ("cuda", "ref")


def ssd_decode(h, x, b, c, dt, da, D, *, impl: str = "cuda"):
    """One Mamba2 layer's decode state and read-out. h [B,H,P,N] float32;
    x [B,H,P] and b, c [B,G,N] (bf16 or float32, one dtype); dt, da [B,H]
    and D [H] float32. Returns (h' [B,H,P,N], y [B,H,P] float32)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    K.check_inputs(h, x, b, c, dt, da, D)
    if impl == "cuda" and h.is_cuda:
        y = K.ssd_decode_cuda(h, x, b, c, dt, da, D)
        ssd_decode.launches += 1
        return h, y
    return R.ssd_decode_ref(h, x, b, c, dt, da, D)


ssd_decode.launches = 0
