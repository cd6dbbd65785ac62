"""Launcher of the flash-attention CUDA kernels (``csrc/prefill.cu``).

``flash_attention_cuda`` replaces ``repro/kernels/flash_attention/
kernel.py`` ``flash_attention_tpu``. Bound by operations: the products
Q K^T and P V of every pair of tiles inside the causal / sliding-window
band. The kv head of query head h is h // (H/K), with no expansion. Any
Sq <= Skv, and any Sq against any Skv for full attention (neither causal
nor windowed: cross-attention, whose queries outnumber the encoder's or
image's keys at prefill length; the right-aligned query offset Skv - Sq is
read only by the causal and window masks), and any head dim up to 128
(the TPU wrapper's padding of D to 128 lanes is not needed; ``sm_scale`` is
1/sqrt(D)). q, k and v are read
through their strides, so [B, S, H, D] activations viewed as [B, H, S, D]
need no copy.

* bf16 inputs with any head dim up to 128, strides that are multiples of
  8 elements and 16-byte aligned bases (the prefill's case), run on
  Hopper's warpgroup products (``wgmma``) fed by TMA: one block per (batch,
  head, 128-query tile), two consumer warpgroups and a producer warp that
  streams 128-key K and V tiles through a two-stage ring. The TMA fills
  the head-dim columns past D with zeros, so a D that is not a multiple of
  16 (h2o-danube's 120) reads the zero-padded tiles the TPU wrapper builds
  by padding D to 128 lanes, without a copy. P V takes p as a bf16 high
  part plus the bf16 of its remainder, two products into one float32
  accumulator, so p stays near float32 as in the TPU kernel, which widens
  v and takes P V in float32.
* f32 inputs, and bf16 inputs whose strides or bases the TMA cannot take,
  run on the same warpgroup products in TF32 with every float32 operand
  split in a TF32 high part and the TF32 of its remainder, three products
  for each of Q K^T and P V (3xTF32; p is split too), so f32 keeps float32
  accuracy: one block per (batch, head, 64-query tile), a producer
  warpgroup that stages each 64-key K and V tile through its strides (split,
  V transposed: TF32 products take K-major operands only) for a consumer
  warpgroup that runs the products and the online softmax.

The launcher reports the kernel it took; ``flash_attention_cuda.routes``
counts launches by route (``"wgmma"``, ``"tf32x3"``). A failed launch
raises: neither kernel stands in for the other.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import check_strided, load_library, stream_of

MAX_HEAD_DIM = 128
DTYPES = (torch.bfloat16, torch.float32)
ROUTES = {1: "wgmma", 2: "tf32x3"}      # by the launcher's route code


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,Sq,D]; k, v [B,K,Skv,D]; bf16 or f32, last dimension
    contiguous. Returns [B,H,Sq,D] in q's dtype."""
    check_strided(q, DTYPES, 4, "q")
    for name, x in (("k", k), ("v", v)):
        check_strided(x, (q.dtype,), 4, name)
    B, H, Sq, D = q.shape
    K, Skv = k.shape[1], k.shape[2]
    full = not causal and window is None
    if (k.shape != (B, K, Skv, D) or v.shape != k.shape or H % K
            or not 1 <= D <= MAX_HEAD_DIM or Sq < 1 or Skv < 1
            or (Sq > Skv and not full)):
        raise ValueError(
            f"flash_attention: bad shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} (K divides H, head dim "
            f"<= {MAX_HEAD_DIM}, 1 <= Sq <= Skv unless neither causal nor "
            "windowed)")
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        load_library("prefill").call(
            "flash_attention_launch", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, H, K, Sq, Skv, D, *strides,
            int(causal), int(window is not None), int(window or 0),
            ctypes.c_float(scale), int(q.dtype == torch.bfloat16),
            ctypes.byref(route), stream_of(q))
    flash_attention_cuda.routes[ROUTES[route.value]] += 1
    return out


flash_attention_cuda.routes = {name: 0 for name in ROUTES.values()}
