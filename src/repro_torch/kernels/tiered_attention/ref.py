"""Plain torch version of the tiered paged-attention kernel (one to one with
the reference's ``kernels/tiered_attention/ref.py``).

Computes a *pool-partial* attention: online-softmax statistics plus per-page
attention mass over ONE pool (fast or slow). Two partials merge into the
final output (``merge_partials_ref``), as in the serving path's
``tiered_paged_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def pool_attention_partial_ref(q, pool_k, pool_v, slot_page, seq_len, *,
                               window: Optional[int] = None,
                               sm_scale: Optional[float] = None):
    """q: [B,H,D]; pool_k/v: [B,Mp,pt,K,D]; slot_page: [B,Mp] (absolute page
    id, -1 free); seq_len: [B] (current position, inclusive).

    Returns (acc [B,H,D] f32 — UNNORMALIZED, m [B,H], l [B,H],
             mass [B,H,Mp] — per-head unnormalized page attention mass,
             relative to each head's final m)."""
    B, Mp, pt, K, D = pool_k.shape
    H = q.shape[1]
    G = H // K
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    ke = torch.repeat_interleave(pool_k, G, dim=3).reshape(B, Mp * pt, H, D)
    ve = torch.repeat_interleave(pool_v, G, dim=3).reshape(B, Mp * pt, H, D)
    s = torch.einsum("bhd,bthd->bht", q.to(torch.float32) * scale,
                     ke.to(torch.float32))
    tok = (slot_page.to(torch.int32) * pt)[:, :, None] + torch.arange(
        pt, dtype=torch.int32, device=q.device)
    ok = (slot_page >= 0)[:, :, None] & (tok <= seq_len[:, None, None])
    if window is not None:
        ok &= tok > (seq_len[:, None, None] - window)
    ok = ok.reshape(B, 1, Mp * pt)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)                                     # [B,H]
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bht,bthd->bhd", p, ve.to(torch.float32))
    mass = p.reshape(B, H, Mp, pt).sum(dim=-1)             # [B,H,Mp]
    return acc, m, l, mass


def merge_partials_ref(q_dtype, partials):
    """Merge pool partials [(acc,m,l,mass), ...] -> (out [B,H,D], masses)."""
    m = torch.stack([p[1] for p in partials]).amax(dim=0)  # [B,H]
    outs, masses, l_tot = None, [], None
    for acc, mp, lp, mass in partials:
        c = torch.exp(mp - m)                              # [B,H]
        l_tot = lp * c if l_tot is None else l_tot + lp * c
        outs = (acc * c[..., None] if outs is None
                else outs + acc * c[..., None])
        masses.append(mass * c[:, :, None])
    out = outs / torch.clamp(l_tot[..., None], min=1e-30)
    denom = torch.clamp(l_tot.sum(dim=1), min=1e-30)       # [B]
    page_masses = [mm.sum(dim=1) / denom[:, None] for mm in masses]
    return out.to(q_dtype), page_masses
