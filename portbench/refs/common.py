"""Plain building blocks of the benchmark's references, in float32.

Nothing here imports the program or JAX: every function takes plain
tensors (the weights the benchmark drew from the seed, read only) and
works everything out again in float32 with TF32 off. ``mode`` selects the
precision of the weight products: ``"float32"`` is the reference, and
``"fp8"`` is the control, the reference with every weight product's two
operands rounded to float8 e4m3 (each row of the activations and each
column of the weight scaled to the format's range first), the step below
the bfloat16 that the configurations state.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32
MODES = ("float32", "fp8")
FP8_MAX = 448.0          # largest finite float8 e4m3fn value


def no_tf32() -> None:
    """Float32 products in float32: the references run with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_call(grad: bool, fn, *args):
    """``fn(*args)``; under autograd, recomputed in the backward so that only
    the layer's inputs are kept."""
    if not grad:
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean cross-entropy of float32 logits [..., V] against labels [...]."""
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(),
        labels.reshape(-1).long())


def to_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 after scaling each slice along ``dim``
    (the contraction axis) to the format's range; returned in float32. Under
    autograd the gradient passes the rounding unchanged (straight through),
    so that the products of the forward are the control's, not a gradient
    flushed to float8."""
    with torch.no_grad():
        amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        scale = amax / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return q + (x - x.detach())


def mm(x: torch.Tensor, w: torch.Tensor, mode: str = "float32"
       ) -> torch.Tensor:
    """x [..., k] times w [k, *rest] in float32 -> [..., *rest]."""
    w2 = w.reshape(w.shape[0], -1).to(F32)
    x = x.to(F32)
    if mode == "fp8":
        x, w2 = to_fp8(x, -1), to_fp8(w2, 0)
    elif mode != "float32":
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return (x @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.to(F32)


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float
           ) -> torch.Tensor:
    """Rotate the two halves of each head: x [B, S, n, D], positions [S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=F32, device=x.device)
                            / half)
    ang = positions.to(F32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, *, window: Optional[int], block: int = 512
              ) -> torch.Tensor:
    """Causal attention, optionally within a window of ``window`` keys,
    computed a block of ``block`` query rows at a time (the scores of one
    block over the keys it can see, in float32). q [B,S,H,D]; k, v
    [B,S,K,D] -> [B,S,H,D]."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, S, H, D), dtype=F32, device=q.device)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        t0 = 0 if window is None else max(0, s0 - window + 1)
        ke = k[:, t0:s1].to(F32).repeat_interleave(rep, dim=2)
        ve = v[:, t0:s1].to(F32).repeat_interleave(rep, dim=2)
        sc = torch.einsum("bshd,bthd->bhst", q[:, s0:s1].to(F32) * scale, ke)
        qpos = torch.arange(s0, s1, device=q.device)[:, None]
        kpos = torch.arange(t0, s1, device=q.device)[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        sc = sc.masked_fill(~ok, float("-inf"))
        out[:, s0:s1] = torch.einsum("bhst,bthd->bshd",
                                     torch.softmax(sc, dim=-1), ve)
    return out


def attention_block(p, a: torch.Tensor, sizes: dict, mode: str,
                    window: Optional[int]) -> torch.Tensor:
    """The attention body of a block: projections, rotary at positions 0..S-1,
    causal attention, output projection. a [B, S, d] -> [B, S, d]."""
    B, S, _ = a.shape
    pos = torch.arange(S, device=a.device)
    theta = sizes["rope_theta"]
    q = rotary(mm(a, p["wq"], mode), pos, theta)
    k = rotary(mm(a, p["wk"], mode), pos, theta)
    v = mm(a, p["wv"], mode)
    o = attention(q, k, v, window=window)
    return mm(o.reshape(B, S, -1), p["wo"].reshape(-1, p["wo"].shape[-1]),
              mode)


def mlp(p, x: torch.Tensor, mode: str) -> torch.Tensor:
    """SwiGLU (``wg``, ``wu``, ``wd``) or the tanh-GELU MLP with biases."""
    if "wg" in p:
        return mm(F.silu(mm(x, p["wg"], mode)) * mm(x, p["wu"], mode),
                  p["wd"], mode)
    h = F.gelu(mm(x, p["w1"], mode) + p["b1"].to(F32), approximate="tanh")
    return mm(h, p["w2"], mode) + p["b2"].to(F32)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x [B, S, C], w [W, C]."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x.to(F32), (0, 0, width - 1, 0))
    return sum(xp[:, j:j + s] * w[j].to(F32) for j in range(width))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., q] -> [..., q, q]: sum of a over (j, i] below the diagonal,
    -inf above it."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    low = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~low, float("-inf"))


def ssd(x, a, b, c, chunk: int, group: int = 16):
    """The Mamba2 scan h_t = exp(a_t) h_{t-1} + b_t x_t^T, y_t = h_t c_t by
    the chunked state-space-duality algorithm (arXiv:2405.21060, Listing
    1), ``group`` chunks at a time with the state carried between groups;
    the decays' cumulative sums and their differences in float64.
    x [B,S,H,P] (dt-scaled), a [B,S,H], b, c [B,S,H,N] -> (y [B,S,H,P],
    the final state [B,H,P,N]), float32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    pad = (-S) % chunk                  # zero inputs at decay 1 change nothing
    if pad:
        x, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
        a = F.pad(a, (0, 0, 0, pad))
    h = torch.zeros((B, H, P, N), dtype=F32, device=x.device)
    ys = []
    span = chunk * group
    for s0 in range(0, x.shape[1], span):
        sl = slice(s0, s0 + span)
        y, h = _ssd_span(x[:, sl], a[:, sl], b[:, sl], c[:, sl], chunk, h)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def _ssd_span(x, a, b, c, chunk: int, h0):
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // chunk
    xr = x.reshape(B, nc, chunk, H, P).to(F32)
    br = b.reshape(B, nc, chunk, H, N).to(F32)
    cr = c.reshape(B, nc, chunk, H, N).to(F32)
    a64 = a.reshape(B, nc, chunk, H).permute(0, 1, 3, 2).to(torch.float64)
    a_cum = torch.cumsum(a64, dim=-1)                       # [B,c,H,q]
    decay = torch.exp(_segsum(a64)).to(F32)                  # [B,c,H,q,q]
    y = torch.einsum("bclhn,bcshn,bchls,bcshp->bclhp", cr, br, decay, xr)
    to_end = torch.exp(a_cum[..., -1:] - a_cum).to(F32)
    states = torch.einsum("bcshn,bchs,bcshp->bchpn", br, to_end, xr)
    states = torch.cat([h0[:, None], states], dim=1)
    totals = F.pad(a_cum[..., -1].permute(0, 2, 1), (1, 0))  # [B,H,c+1]
    carry = torch.exp(_segsum(totals)).to(F32)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)
    y = y + torch.einsum("bclhn,bchpn,bchl->bclhp", cr, states[:, :-1],
                         torch.exp(a_cum).to(F32))
    return y.reshape(B, S, H, P), states[:, -1]
