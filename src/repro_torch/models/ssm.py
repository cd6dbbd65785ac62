"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) in torch (port of
the reference's ``models/ssm.py``).

The chunked SSD algorithm (``ssd_chunked``) is the plain version of the K8
kernel (``kernels/ssd_scan``); ``mamba_block`` (prefill) sends the scan
through the ``ssd_scan`` op, and ``mamba_decode_step`` is the O(1)-state
recurrent step of the serving path (its state update and read-out through
the ``ssd_decode`` op, the decode-state kernel on a CUDA tensor). Layouts
and parameter names are the reference's: split projections
``wx``/``wz``/``wB``/``wC``/``wdt``, depthwise convolutions ``conv_*``
[W, C], per-head ``dt_bias``, ``A_log`` and ``D``.

Three differences from the reference's jnp, each the same function:
``jax.nn.softplus`` is ``logaddexp(x, 0)`` (torch's ``softplus`` switches
to ``x`` above 20); the depthwise causal convolution is the sum of W
shifted float32 products (``F.conv1d`` would go through cuDNN, which
allows TF32 on the card); groups broadcast to heads with
``repeat_interleave`` (``jnp.repeat``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamSpec, dtype_of
from repro_torch.numerics import fused_mul_add
from repro_torch.obs.spans import span


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, groups, state size) of ``cfg``'s Mamba2 blocks."""
    s: SSMConfig = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    assert nh * s.head_dim == di, (di, s.head_dim)
    return di, nh, s.ngroups, s.state_dim


def mamba_specs(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di, nh, g, n = ssm_dims(cfg)
    return {
        "norm": ParamSpec((d,), init="ones"),
        "wx": ParamSpec((d, di)),
        "wz": ParamSpec((d, di)),
        "wB": ParamSpec((d, g * n)),
        "wC": ParamSpec((d, g * n)),
        "wdt": ParamSpec((d, nh), init="small"),
        "conv_x": ParamSpec((s.conv_width, di), init="small"),
        "conv_B": ParamSpec((s.conv_width, g * n), init="small"),
        "conv_C": ParamSpec((s.conv_width, g * n), init="small"),
        "dt_bias": ParamSpec((nh,), init="zeros"),
        "A_log": ParamSpec((nh,), init="zeros"),
        "D": ParamSpec((nh,), init="ones"),
        "gnorm": ParamSpec((di,), init="ones"),
        "wo": ParamSpec((di, d)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in float32. x: [B,S,C], w: [W,C]."""
    width = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x.to(torch.float32), (0, 0, width - 1, 0))
    wf = w.to(torch.float32)
    out = xp[:, 0:s] * wf[0]
    for k in range(1, width):
        out = out + xp[:, k:k + s] * wf[k]
    return out.to(x.dtype)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., q] log-decays -> [..., q, q] with L[i,j] = sum_{k=j+1..i} a_k
    for i >= j and -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, a, b, c, chunk: int, h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan (Mamba2 paper, Listing 1).

    x: [B,S,H,P] (already dt-scaled), a: [B,S,H] log decay (dt*A, negative),
    b, c: [B,S,H,N] (groups broadcast to heads).
    Returns y: [B,S,H,P] in x's dtype, h_final: [B,H,P,N] float32.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    f32 = torch.float32
    xr = x.reshape(B, nc, chunk, H, P).to(f32)
    ar = a.reshape(B, nc, chunk, H).permute(0, 1, 3, 2).to(f32)  # [B,c,H,q]
    br = b.reshape(B, nc, chunk, H, N).to(f32)
    cr = c.reshape(B, nc, chunk, H, N).to(f32)

    # a_cum and its differences in float64, rounded once before exp: in
    # float32, a_cum_i - a_cum_j cancels to about one ulp of |a_cum|, and
    # under strong decays (|a_cum| ~ 1e3 at the end of a 256-step chunk)
    # two float32 sums in different orders disagree by ~1e-3 in y
    a64 = ar.to(torch.float64)
    a_cum = torch.cumsum(a64, dim=-1)                             # [B,c,H,q]
    L = torch.exp(segsum(a64).to(f32))                            # [B,c,H,q,q]
    # intra-chunk (diagonal blocks)
    scores = torch.einsum("bclhn,bcshn->bchls", cr, br) * L
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xr)
    # per-chunk states
    decay_states = torch.exp((a_cum[..., -1:] - a_cum).to(f32))  # [B,c,H,q]
    states = torch.einsum("bcshn,bchs,bcshp->bchpn", br, decay_states, xr)
    # inter-chunk recurrence
    if h0 is None:
        h0 = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    states_cat = torch.cat([h0[:, None].to(f32), states], dim=1)
    chunk_sum = a_cum[..., -1].permute(0, 2, 1)                   # [B,H,c]
    decay_chunk = torch.exp(segsum(F.pad(chunk_sum, (1, 0))).to(f32))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states_cat)
    prev_states, h_final = new_states[:, :-1], new_states[:, -1]
    # inter-chunk contribution
    state_decay_out = torch.exp(a_cum.to(f32))                    # [B,c,H,q]
    y_off = torch.einsum("bclhn,bchpn,bchl->bclhp", cr, prev_states,
                         state_decay_out)
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), h_final


def ssd_recurrent_ref(x, a, b, c, h0=None):
    """O(S·N) sequential reference (oracle for ``ssd_chunked`` and K8)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    f32 = torch.float32
    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    ys = []
    for t in range(S):
        h = h * torch.exp(a[:, t].to(f32))[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", b[:, t].to(f32), x[:, t].to(f32))
        ys.append(torch.einsum("bhn,bhpn->bhp", c[:, t].to(f32), h))
    return torch.stack(ys, dim=1).to(x.dtype), h


class MambaCache(NamedTuple):
    """Decode state, one per layer or stacked on a leading layer axis."""
    h: torch.Tensor          # [B, H, P, N] SSM state, float32
    conv_x: torch.Tensor     # [B, W-1, di]
    conv_B: torch.Tensor     # [B, W-1, g*n]
    conv_C: torch.Tensor     # [B, W-1, g*n]


def init_mamba_cache(cfg: ModelConfig, batch: int, n_layers: int,
                     device="cuda") -> MambaCache:
    """Zero decode state for ``n_layers`` stacked layers: ``h`` in float32,
    the convolution buffers in the compute dtype."""
    dev = resolve_device(device)
    di, nh, g, n = ssm_dims(cfg)
    s = cfg.ssm
    w = s.conv_width - 1
    dt = dtype_of(cfg.dtype)
    return MambaCache(
        h=torch.zeros((n_layers, batch, nh, s.head_dim, n),
                      dtype=torch.float32, device=dev),
        conv_x=torch.zeros((n_layers, batch, w, di), dtype=dt, device=dev),
        conv_B=torch.zeros((n_layers, batch, w, g * n), dtype=dt, device=dev),
        conv_C=torch.zeros((n_layers, batch, w, g * n), dtype=dt, device=dev))


def _project(p, u: torch.Tensor, cfg: ModelConfig):
    dt = dtype_of(cfg.dtype)
    return tuple(u @ p[k].to(dt) for k in ("wx", "wz", "wB", "wC", "wdt"))


def _decay(p, dtv: torch.Tensor):
    """(dt [.., H], A [H]) in float32: softplus(dt + dt_bias), -exp(A_log)."""
    dt_f = softplus(dtv.to(torch.float32) + p["dt_bias"].to(torch.float32))
    return dt_f, -torch.exp(p["A_log"].to(torch.float32))


def mamba_block(p, u: torch.Tensor, cfg: ModelConfig, *, impl: str = "cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block (prefill). u: [B,S,D] -> ([B,S,D],
    h_final [B,H,P,N]). The scan goes through the ``ssd_scan`` op (K8 on a
    CUDA tensor) with ``impl="cuda"``, straight to its plain version with
    ``impl="ref"``; B and C stay per group ([B,S,G,N]). Spans: the block
    in ``mamba.block``, its scan in ``mamba.scan``."""
    # imported here: the kernel's plain version imports this module
    from repro_torch.kernels.ssd_scan import ops as SSD
    s: SSMConfig = cfg.ssm
    di, nh, g, n = ssm_dims(cfg)
    B, S, _ = u.shape
    with span("mamba.block"):
        un = rms_norm(u, p["norm"], cfg.rms_eps)
        x, z, bb, cc, dtv = _project(p, un, cfg)
        x = F.silu(_causal_conv(x, p["conv_x"]))
        bb = F.silu(_causal_conv(bb, p["conv_B"]))
        cc = F.silu(_causal_conv(cc, p["conv_C"]))
        dt_f, A = _decay(p, dtv)                                  # [B,S,H]
        a = dt_f * A                                              # log-decay
        xh = x.reshape(B, S, nh, s.head_dim)
        xdt = xh.to(torch.float32) * dt_f[..., None]
        with span("mamba.scan"):
            y, h_fin = SSD.ssd_scan(xdt, a, bb.reshape(B, S, g, n),
                                    cc.reshape(B, S, g, n),
                                    chunk=min(s.chunk_size, S), impl=impl)
        y = y + p["D"].to(torch.float32)[None, None, :, None] * xh.to(
            torch.float32)
        y = y.reshape(B, S, di)
        y = rms_norm(y.to(u.dtype) * F.silu(z), p["gnorm"], cfg.rms_eps)
        out = y @ p["wo"].to(dtype_of(cfg.dtype))
        return u + out, h_fin


def _conv_step(buf: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """One causal-conv step. buf: [B, W-1, C]; new: [B, 1, C]. Returns
    (silu(conv) [B, 1, C] in new's dtype, the next buffer)."""
    seq = torch.cat([buf, new], dim=1)                            # [B, W, C]
    out = torch.einsum("bwc,wc->bc", seq.to(torch.float32),
                       w.to(torch.float32))[:, None]
    return F.silu(out).to(new.dtype), seq[:, 1:]


def state_update(h, da, xh, bh, dt_f) -> torch.Tensor:
    """h [B,H,P,N] * da [B,H] + outer(xh [B,H,P], bh [B,H,N] * dt_f [B,H]):
    the jitted reference forms ``b * dt`` first (its einsum
    "bhn,bhp,bh->bhpn") and rounds the multiply-add once."""
    return fused_mul_add(
        h, da[..., None, None],
        xh[..., None] * (bh * dt_f[..., None])[:, :, None, :])


def mamba_decode_step(p, u: torch.Tensor, cache: MambaCache,
                      cfg: ModelConfig, *, impl: str = "cuda"
                      ) -> Tuple[torch.Tensor, MambaCache]:
    """Single-token step. u: [B,1,D] -> ([B,1,D], new cache). The state
    update and its read-out go through the ``ssd_decode`` op (span
    ``mamba.state``): on a CUDA tensor with ``impl="cuda"`` the
    decode-state kernel updates ``cache.h`` in place and the new cache
    holds that same tensor; otherwise the plain version returns a new
    state."""
    # imported here: the kernel's plain version imports this module
    from repro_torch.kernels.ssd_decode import ops as SDEC
    s: SSMConfig = cfg.ssm
    di, nh, g, n = ssm_dims(cfg)
    B = u.shape[0]
    un = rms_norm(u, p["norm"], cfg.rms_eps)
    x, z, bb, cc, dtv = _project(p, un, cfg)
    x1, cx = _conv_step(cache.conv_x, x, p["conv_x"])
    b1, cb = _conv_step(cache.conv_B, bb, p["conv_B"])
    c1, ccv = _conv_step(cache.conv_C, cc, p["conv_C"])
    dt_f, A = _decay(p, dtv[:, 0])                                # [B,H]
    da = torch.exp(dt_f * A)
    with span("mamba.state"):
        h, y = SDEC.ssd_decode(
            cache.h, x1[:, 0].reshape(B, nh, s.head_dim),
            b1[:, 0].reshape(B, g, n), c1[:, 0].reshape(B, g, n), dt_f, da,
            p["D"].to(torch.float32), impl=impl)
    y = y.reshape(B, 1, di)
    y = rms_norm(y.to(u.dtype) * F.silu(z), p["gnorm"], cfg.rms_eps)
    out = y @ p["wo"].to(dtype_of(cfg.dtype))
    return u + out, MambaCache(h=h, conv_x=cx, conv_B=cb, conv_C=ccv)
