"""Launcher of the Mamba2 decode-state CUDA kernel (``csrc/serving.cu``).

``ssd_decode_cuda`` replaces no TPU kernel: the reference's decode step
(``repro/models/ssm.py`` ``mamba_decode_step``) is plain jnp. One launch
does one Mamba2 layer's step from the conv outputs to y: the state update
``h' = h * da + x (B dt)^T`` with the plain version's float64 multiply-add
(one rounding to float32), stored over ``h`` in place, and the read-out
``y = h' C + D x``. It streams the state once: a warp per (batch, head)
tile, 16-byte copies into a three-stage ``cp.async`` ring in shared memory
and 16-byte stores along N, float64 only in registers. Bound by
device-memory bytes, 2 x B*H*P*N*4 a layer.

x, B and C are read through their strides (the conv step's outputs are
transposed views). ``check_inputs`` holds what the kernel takes; the
wrapper (``ops.py``) calls it on every route, so both refuse the same
arguments.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library, stream_of

MAX_N = 128
LOW_DTYPES = (torch.bfloat16, torch.float32)


def check_inputs(h, x, b, c, dt, da, D) -> None:
    """Raise ValueError unless h [B,H,P,N] float32, dt, da [B,H] and D [H]
    float32 are contiguous, x [B,H,P] and b, c [B,G,N] are of one dtype
    (bf16 or float32, any strides: the kernel reads them through theirs),
    G divides H and N is a multiple of 4 up to ``MAX_N``."""
    tensors = {"h": h, "x": x, "b": b, "c": c, "dt": dt, "da": da, "D": D}
    for name, t in tensors.items():
        want = (LOW_DTYPES if name == "x" else
                (x.dtype,) if name in ("b", "c") else (torch.float32,))
        if t.dtype not in want:
            raise ValueError(f"ssd_decode: {name} is {t.dtype}, expected "
                             f"one of {want}")
        if name not in ("x", "b", "c") and not t.is_contiguous():
            raise ValueError(f"ssd_decode: {name} is not contiguous "
                             f"(strides {t.stride()})")
    if h.dim() != 4 or x.dim() != 3 or b.dim() != 3:
        raise ValueError(f"ssd_decode: expected h 4-D, x and b 3-D, got "
                         f"{tuple(h.shape)}, {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    B, H, P, N = h.shape
    G = b.shape[1]
    if (x.shape != (B, H, P) or b.shape != (B, G, N) or c.shape != b.shape
            or dt.shape != (B, H) or da.shape != (B, H) or D.shape != (H,)
            or G < 1 or H % G):
        raise ValueError(
            f"ssd_decode: bad shapes h {tuple(h.shape)} x {tuple(x.shape)} "
            f"b {tuple(b.shape)} c {tuple(c.shape)} dt {tuple(dt.shape)} "
            f"da {tuple(da.shape)} D {tuple(D.shape)} (G divides H)")
    if N % 4 or not 4 <= N <= MAX_N:
        raise ValueError(f"ssd_decode: state size N={N} is not a multiple "
                         f"of 4 up to {MAX_N}")


def ssd_decode_cuda(h, x, b, c, dt, da, D) -> torch.Tensor:
    """The arguments as ``check_inputs`` takes them, on one CUDA device.
    Updates ``h`` in place and returns y [B,H,P] float32."""
    for name, t in (("h", h), ("x", x), ("b", b), ("c", c), ("dt", dt),
                    ("da", da), ("D", D)):
        if t.device != h.device or not t.is_cuda:
            raise ValueError(f"ssd_decode: {name} is on {t.device}, "
                             f"expected h's CUDA device")
    if h.data_ptr() % 16:
        raise ValueError("ssd_decode: h is not 16-byte aligned")
    B, H, P, N = h.shape
    y = torch.empty((B, H, P), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        load_library("serving").call(
            "ssd_decode_state_launch", h.data_ptr(), x.data_ptr(),
            b.data_ptr(), c.data_ptr(), dt.data_ptr(), da.data_ptr(),
            D.data_ptr(), y.data_ptr(), B, H, b.shape[1], P, N,
            *x.stride(), *b.stride(), *c.stride(),
            int(x.dtype == torch.bfloat16), stream_of(h))
    return y
