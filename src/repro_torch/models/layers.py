"""Core neural layers of the dense decoder (torch port of the reference's
``models/layers.py``: norms, rotary, the attention projections, SwiGLU and
the materialised-scores attention used by the full-sequence forward).

Layouts are the reference's: activations [B, S, d], heads [B, S, H, D],
weights ``wq`` [d, H, D], ``wk``/``wv`` [d, K, D], ``wo`` [H, D, d]. Each
function takes one layer's parameters as a mapping (``p["wq"]``), casts the
weights to the activation dtype at use, and upcasts to float32 exactly where
the reference does. The tiered paged decode attention lives in
``memtier/kvcache.py`` and ``kernels/tiered_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import dtype_of

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(dt)


def rotary_embed(x: torch.Tensor, positions: torch.Tensor,
                 theta: float) -> torch.Tensor:
    """x: [..., S, n_heads, head_dim]; positions: [..., S] (int)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs       # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] contracted with the first axis of w [d, *rest]."""
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def attention_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions):
    """Project to q, k, v (+qk-norm, +rope). Returns q [B,S,H,D] and
    k, v [B,S,K,D]."""
    dt = dtype_of(cfg.dtype)
    q = _proj(x, p["wq"].to(dt))
    k = _proj(x, p["wk"].to(dt))
    v = _proj(x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if positions is not None:
        q = rotary_embed(q, positions, cfg.rope_theta)
        k = rotary_embed(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(p, attn: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """attn [B,S,H,D] -> [B,S,d] through ``wo`` [H,D,d]."""
    wo = p["wo"].to(dtype_of(cfg.dtype))
    return attn.reshape(*attn.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU MLP (the only activation of the ported family)."""
    if "wg" not in p:
        raise NotImplementedError("only the SwiGLU MLP is ported")
    dt = dtype_of(cfg.dtype)
    g = x @ p["wg"].to(dt)
    u = x @ p["wu"].to(dt)
    return (F.silu(g) * u) @ p["wd"].to(dt)


def _expand_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """[B,T,K,D] -> [B,T,H,D]; head i attends kv head i // (H/K)."""
    kh = k.shape[2]
    return k if kh == h else torch.repeat_interleave(k, h // kh, dim=2)


def attn_dense(q, k, v, *, causal: bool, window: Optional[int] = None,
               q_offset: int = 0) -> torch.Tensor:
    """Materialised-scores attention. q [B,S,H,D]; k, v [B,T,K,D] ->
    [B,S,H,D]."""
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    ke = _expand_kv(k, h).to(torch.float32)
    ve = _expand_kv(v, h).to(torch.float32)
    scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32) * scale, ke)
    if causal or window is not None:
        qpos = torch.arange(s, device=q.device) + q_offset
        kpos = torch.arange(t, device=q.device)
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(mask[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, ve)
    return out.to(q.dtype)
