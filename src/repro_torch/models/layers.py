"""Core neural layers of the decoders (torch port of the reference's
``models/layers.py``: norms, rotary, the attention projections, SwiGLU and
the GELU MLP with biases, the top-k mixture of experts, cross-attention and
the materialised-scores attention cores).

Layouts are the reference's: activations [B, S, d], heads [B, S, H, D],
weights ``wq`` [d, H, D], ``wk``/``wv`` [d, K, D], ``wo`` [H, D, d]. Each
function takes one layer's parameters as a mapping (``p["wq"]``), casts the
weights to the activation dtype at use, and upcasts to float32 exactly where
the reference does. Full-sequence self-attention (``self_attention``) and
cross-attention (``cross_attention``, non-causal, queries against encoder
or image positions) go through the ``flash_attention`` op (K7);
``attn_dense`` stays the plain materialised form, and ``attn_decode``
(single-query attention against a contiguous cache, the decode step's
cross-attention) is the reference's plain product, outside any kernel
there and here. The tiered paged decode attention lives in
``memtier/kvcache.py`` and ``kernels/tiered_attention``. The MoE products
are the reference's plain products (no Pallas kernel there, none here).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.select.ref import top_k
from repro_torch.models.params import ParamSpec, dtype_of

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


def attention_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions, *,
                  kv_x: Optional[torch.Tensor] = None, rope: bool = True):
    """Project to q, k, v (+qk-norm, +rope). q comes from ``x`` and k, v
    from ``kv_x`` (cross-attention) or ``x``. Returns q [B,S,H,D] and k, v
    [B,T,K,D]. Rope applies to self-attention with positions only."""
    dt = dtype_of(cfg.dtype)
    kv_src = x if kv_x is None else kv_x
    q = _proj(x, p["wq"].to(dt))
    k = _proj(kv_src, p["wk"].to(dt))
    v = _proj(kv_src, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if rope and kv_x is None and positions is not None:
        q = rotary_embed(q, positions, cfg.rope_theta)
        k = rotary_embed(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(p, attn: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """attn [B,S,H,D] -> [B,S,d] through ``wo`` [H,D,d]."""
    wo = p["wo"].to(dtype_of(cfg.dtype))
    return attn.reshape(*attn.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def self_attention(p, x: torch.Tensor, cfg: ModelConfig, positions, *,
                   causal: bool = True, window: Optional[int] = None,
                   impl: str = "cuda") -> torch.Tensor:
    """Full self-attention block body (no residual/norm). The reference
    routes to ``attn_dense``, ``attn_chunked`` or ``attn_local`` by length
    and window; the three compute one function, which the ``flash_attention``
    op (K7 on a CUDA tensor; its plain version with ``impl="ref"``)
    computes at every length, skipping the key tiles outside the band."""
    q, k, v = attention_qkv(p, x, cfg, positions)
    attn = FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              impl=impl)
    return attention_out(p, attn.transpose(1, 2), cfg)


def cross_attention(p, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
                    *, impl: str = "cuda") -> torch.Tensor:
    """Cross-attention block body: queries from ``x`` [B,S,d], keys and
    values from ``enc`` [B,T,d], no rope, no mask. The reference's
    ``attn_dense`` materialises [B, H, S, T] float32 scores; the
    ``flash_attention`` op computes the same function non-causally, with S
    longer than T at prefill length."""
    q, k, v = attention_qkv(p, x, cfg, None, kv_x=enc, rope=False)
    attn = FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=False, impl=impl)
    return attention_out(p, attn.transpose(1, 2), cfg)


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU (``wg``/``wu``/``wd``), or the GELU MLP with biases
    (``w1``/``b1``/``w2``/``b2``, ``act="gelu"``): ``jax.nn.gelu``'s
    default tanh form, the biases added in the activation dtype."""
    dt = dtype_of(cfg.dtype)
    if "wg" in p:
        g = x @ p["wg"].to(dt)
        u = x @ p["wu"].to(dt)
        return (F.silu(g) * u) @ p["wd"].to(dt)
    h = x @ p["w1"].to(dt) + p["b1"].to(dt)
    h = F.gelu(h, approximate="tanh")
    return h @ p["w2"].to(dt) + p["b2"].to(dt)


def moe_specs(cfg: ModelConfig):
    """A MoE layer's parameters: the router [d, E] (std 0.02) and the
    experts' SwiGLU weights ``wg``/``wu`` [E, d, f] and ``wd`` [E, f, d]."""
    d, m = cfg.d_model, cfg.moe
    e, f = m.num_experts, m.d_ff_expert
    return {"router": ParamSpec((d, e), init="small"),
            "wg": ParamSpec((e, d, f)), "wu": ParamSpec((e, d, f)),
            "wd": ParamSpec((e, f, d))}


def _router(p, x: torch.Tensor) -> torch.Tensor:
    """Float32 router probabilities [.., E]."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    return torch.softmax(logits, dim=-1)


def _experts(p, xe: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Each expert's SwiGLU over its own rows: xe [E, N, d] -> [E, N, d]."""
    g = torch.bmm(xe, p["wg"].to(dt))
    u = torch.bmm(xe, p["wu"].to(dt))
    return torch.bmm(F.silu(g) * u, p["wd"].to(dt))


def moe_block(p, x: torch.Tensor, cfg: ModelConfig):
    """Top-k MoE with the reference's grouped gather dispatch: each sample
    is a routing group, and every expert takes its top-C member tokens of
    the sample (C = max(ceil(S k / E x capacity_factor), 4), at most S;
    ties to the lower token index), gathered directly. Outputs are
    normalised by the kept gates. x [B, S, d] -> (out [B, S, d], the Switch
    load-balancing aux loss).

    The experts' outputs are added into their tokens one expert after
    another (an ``index_add_`` per expert, whose rows are distinct), so the
    sums associate the same way on every run and device."""
    m = cfg.moe
    dt = dtype_of(cfg.dtype)
    b, s, d = x.shape
    e = m.num_experts
    probs = _router(p, x)                                         # [B,S,E]
    member = probs >= top_k(probs, m.top_k)[0][..., -1:]          # k-th
    score = torch.where(member, probs, 0.0)
    capacity = min(max(math.ceil(s * m.top_k / m.num_experts
                                 * m.capacity_factor), 4), s)
    vals, idx = top_k(score.transpose(1, 2), capacity)            # [B,E,C]
    w = torch.where(vals > 0.0, vals, 0.0)                        # kept gates
    xe = x[torch.arange(b, device=x.device)[:, None, None], idx]  # [B,E,C,d]
    ye = _experts(p, xe.transpose(0, 1).reshape(e, b * capacity, d), dt)
    weighted = ye.to(torch.float32) * w.transpose(0, 1).reshape(
        e, b * capacity, 1)
    rows = (idx + torch.arange(b, device=x.device)[:, None, None] * s
            ).transpose(0, 1).reshape(e, b * capacity)
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    denom = torch.zeros((b * s,), dtype=torch.float32, device=x.device)
    wt = w.transpose(0, 1).reshape(e, b * capacity)
    for i in range(e):
        out.index_add_(0, rows[i], weighted[i])
        denom.index_add_(0, rows[i], wt[i])
    out = out / torch.clamp(denom, min=1e-9)[:, None]
    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))
    ce = member.to(torch.float32).mean(dim=(0, 1)) / m.top_k * m.num_experts
    aux = torch.sum(me * ce)
    return out.reshape(b, s, d).to(dt), aux


def moe_block_decode(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """MoE for decode: every token's top-k experts (ties to the lower
    expert index), gates renormalised to sum to 1, no capacity. x [B, 1, d].

    The reference gathers each token's k expert matrices ([T, k, d, f]); here
    the tokens are grouped by expert instead: token t's j-th expert takes
    it into row ``rank`` of that expert's group (rank: its order among the
    expert's tokens), each expert runs its three products once over its
    group (rows past the group's tokens are zeros and never read back),
    and every token sums its k outputs, weighted by its gates, in float32.
    The same dot products as the reference's; only the float association
    of the k-way sum may differ."""
    m = cfg.moe
    dt = dtype_of(cfg.dtype)
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    tokens = x.reshape(b * s, d)
    n = tokens.shape[0]
    gate, expert = top_k(_router(p, tokens), k)                   # [T,k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    ex = expert.reshape(-1)                                       # [T*k]
    rank = (F.one_hot(ex, e).cumsum(0) - 1).gather(1, ex[:, None])[:, 0]
    xg = tokens.new_zeros((e, n, d))
    xg[ex, rank] = tokens.repeat_interleave(k, dim=0)
    y = _experts(p, xg, dt)[ex, rank].reshape(n, k, d)
    out = torch.einsum("tkd,tk->td", y.to(torch.float32), gate)
    return out.reshape(b, s, d).to(dt)


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


def attn_decode(q, k_cache, v_cache, kv_len: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Single-token attention against a contiguous cache, float32 scores.
    q [B,1,H,D]; caches [B,T,K,D]; kv_len (optional) [B] valid lengths.
    Returns [B,1,H,D]."""
    h, d = q.shape[2], q.shape[3]
    t = k_cache.shape[1]
    scale = 1.0 / math.sqrt(d)
    ke = _expand_kv(k_cache, h).to(torch.float32)
    ve = _expand_kv(v_cache, h).to(torch.float32)
    sc = torch.einsum("bhd,bthd->bht", q[:, 0].to(torch.float32) * scale, ke)
    if kv_len is not None:
        valid = torch.arange(t, device=q.device)[None] < kv_len[:, None]
        sc = torch.where(valid[:, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bht,bthd->bhd", p, ve)
    return out[:, None].to(q.dtype)
