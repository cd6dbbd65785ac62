"""Plain torch version of the flash-attention kernel (one to one with the
reference's ``kernels/flash_attention/ref.py``): GQA, causal, sliding
window, right-aligned queries, materialised float32 scores."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, K, Skv, D] (K divides H). -> [B, H, Sq, D]
    in q's dtype."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    ke = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    ve = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * scale, ke)
    qpos = torch.arange(sq, device=q.device) + (skv - sq)  # right-aligned
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None] > qpos[:, None] - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, ve).to(q.dtype)
