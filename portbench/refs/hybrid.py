"""Plain reference of the hybrid (Zamba2-style) model the program runs: a
Mamba2 backbone, and one weight-shared attention block applied before every
``hybrid_attn_every``-th Mamba2 layer to concat(hidden, token embeddings).

``params`` is the weight tree the benchmark drew (``embed``: ``tok``,
``final_norm``, ``lm_head``; ``layers``: the Mamba2 blocks stacked on a
leading layer axis; ``shared``: ``in_proj``, ``ln1``, ``attn``, ``ln2``,
``mlp``, ``out_proj``); ``sizes`` is the configuration's ``port`` table.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.refs import common as C


def mamba_block(p, u: torch.Tensor, sizes: dict, mode: str) -> torch.Tensor:
    """One Mamba2 block over the whole sequence, plus its residual."""
    ssm, eps = sizes["ssm"], sizes["rms_eps"]
    B, S, d = u.shape
    di = ssm["expand"] * d
    nh, hp = di // ssm["head_dim"], ssm["head_dim"]
    g, n = ssm["ngroups"], ssm["state_dim"]
    un = C.rms_norm(u, p["norm"], eps)
    x = F.silu(C.causal_conv(C.mm(un, p["wx"], mode), p["conv_x"]))
    z = C.mm(un, p["wz"], mode)
    b = F.silu(C.causal_conv(C.mm(un, p["wB"], mode), p["conv_B"]))
    c = F.silu(C.causal_conv(C.mm(un, p["wC"], mode), p["conv_C"]))
    dt = torch.logaddexp(C.mm(un, p["wdt"], mode) + p["dt_bias"].float(),
                         torch.zeros((), device=u.device))
    a = dt * -torch.exp(p["A_log"].float())
    xh = x.reshape(B, S, nh, hp)
    heads = nh // g
    bh = b.reshape(B, S, g, n).repeat_interleave(heads, dim=2)
    ch = c.reshape(B, S, g, n).repeat_interleave(heads, dim=2)
    y, _ = C.ssd(xh * dt[..., None], a, bh, ch, ssm["chunk_size"])
    y = y + p["D"].float()[:, None] * xh
    y = C.rms_norm(y.reshape(B, S, di) * F.silu(z), p["gnorm"], eps)
    return u + C.mm(y, p["wo"], mode)


def shared_block(sp, x: torch.Tensor, emb: torch.Tensor, sizes: dict,
                 mode: str) -> torch.Tensor:
    eps = sizes["rms_eps"]
    h = C.mm(torch.cat([x, emb], dim=-1), sp["in_proj"], mode)
    h = h + C.attention_block(sp["attn"], C.rms_norm(h, sp["ln1"], eps),
                              sizes, mode, sizes.get("sliding_window"))
    h = h + C.mlp(sp["mlp"], C.rms_norm(h, sp["ln2"], eps), mode)
    return x + C.mm(h, sp["out_proj"], mode)


def forward(params, sizes: dict, tokens: torch.Tensor, *,
            mode: str = "float32", last_only: bool = False,
            grad: bool = False) -> torch.Tensor:
    """tokens [B, S] -> float32 logits [B, S, V] ([B, 1, V] with
    ``last_only``). With ``grad`` autograd records, each layer recomputed in
    the backward (``torch.utils.checkpoint``) so that the activations of one
    layer at a time are held."""
    C.no_tf32()
    with torch.set_grad_enabled(grad):
        emb = params["embed"]["tok"][tokens.long()].float()
        x = emb
        every = sizes["hybrid_attn_every"]
        layers = params["layers"]

        def layer(i, x, emb):
            if i % every == 0:
                x = shared_block(params["shared"], x, emb, sizes, mode)
            return mamba_block({k: v[i] for k, v in layers.items()}, x,
                               sizes, mode)

        for i in range(sizes["num_layers"]):
            x = C.layer_call(grad, layer, i, x, emb)
        if last_only:
            x = x[:, -1:]
        x = C.rms_norm(x, params["embed"]["final_norm"], sizes["rms_eps"])
        return C.mm(x, params["embed"]["lm_head"], mode)


# ---- the work of the model, counted from its sizes (``portbench/work.py``)
def mamba_dims(s: dict):
    """(inner width, heads, head width, state width, groups) of Mamba2."""
    m = s["ssm"]
    di = m["expand"] * s["d_model"]
    return di, di // m["head_dim"], m["head_dim"], m["state_dim"], m[
        "ngroups"]


def shared_applications(s: dict) -> int:
    """Applications of the shared block in one forward."""
    every = s["hybrid_attn_every"]
    return (s["num_layers"] + every - 1) // every


def token_macs(s: dict) -> int:
    """Multiply-adds of the weight products one token passes through,
    without the LM head: each Mamba2 layer's projections and each shared
    block application."""
    from portbench import work
    d = s["d_model"]
    di, nh, _, n, g = mamba_dims(s)
    mamba = d * (2 * di + 2 * g * n + nh) + di * d
    shared = 2 * d * d + work.attn_params(s) + work.mlp_params(s) + d * d
    return s["num_layers"] * mamba + shared_applications(s) * shared


def attention_calls(s: dict) -> int:
    """Causal attention calls in one forward."""
    return shared_applications(s)


def scan_flops(s: dict, B: int, S: int) -> int:
    """Operations of every Mamba2 layer's SSD scan over B x S tokens."""
    from portbench import work
    _, nh, p, n, g = mamba_dims(s)
    q = min(s["ssm"]["chunk_size"], S)
    return s["num_layers"] * work.k8(B, S, nh, p, n, g, q)[1]


def state_flops(s: dict, B: int) -> int:
    """Operations of one decode step's Mamba2 state: each layer's update (a
    multiply-add and an outer product, 4 operations a state element) and
    read-out (2)."""
    _, nh, p, n, _ = mamba_dims(s)
    return s["num_layers"] * 6 * B * nh * p * n
