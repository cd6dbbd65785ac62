"""Float arithmetic rules the port needs to agree bit for bit with the
reference.

The reference runs under XLA, whose CPU backend contracts ``a * b + c`` into
one fused multiply-add; torch's eager kernels round the product first. The
EWMA hotness feeds threshold compares and top-k orders, so one ulp there
changes which pages move. ``fused_mul_add`` evaluates the expression in
float64 and rounds once to float32, which reproduces the fused result (the
f32 product is exact in f64).
"""
from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """A Python float rounded to float32, the way JAX weak-types literals."""
    return float(np.float32(x))


def fused_mul_add(a, b, c) -> torch.Tensor:
    """``a * b + c`` with a single float32 rounding. Each operand is a float32
    tensor or a Python float (rounded to float32 first)."""
    def wide(x):
        return x.to(torch.float64) if torch.is_tensor(x) else f32(x)
    return (wide(a) * wide(b) + wide(c)).to(torch.float32)
