"""The work the algorithms need, counted from shapes, and the peaks it is
held against (NVIDIA H100 SXM, published dense rates at 700 W).

A roofline share is the least time the chip could take, the larger of
bytes over the memory bandwidth and operations over the peak rate of the
precision, divided by the measured time. Each input byte is counted once
and each output byte once, whatever an implementation reads again; the
operations are those of the algorithm, not of a kernel's tiling. The peak
is one no correct implementation at the configuration's precision can
beat: bfloat16 products at 989 TFLOP/s, float32 products as three TF32
products (495 / 3 TFLOP/s), as a tensor-core float32 kernel computes them.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 495e12 / 3


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """The least time of ``nbytes`` moved and ``flops`` done at ``peak``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


# ----------------------------------------------------------- kernels ----
def band_pairs(S: int, window) -> int:
    """(query, key) pairs of causal attention over S positions, within a
    window of ``window`` keys when it is set."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def k7(B: int, H: int, K: int, D: int, S: int, window, elem: int = 2):
    """Causal flash attention, one call: (bytes, flops). q and the output
    [B, H, S, D], k and v [B, K, S, D] of ``elem`` bytes; QK^T and PV over
    the band's pairs."""
    nbytes = elem * B * S * D * (2 * H + 2 * K)
    return nbytes, 4 * B * H * D * band_pairs(S, window)


def k8(B: int, S: int, H: int, P: int, N: int, G: int, Q: int):
    """The chunked SSD scan, one call: (bytes, flops). x and y [B, S, H, P]
    float32, the decays a [B, S, H] float32, b and c [B, S, G, N] bfloat16,
    the final state [B, H, P, N] float32. Per chunk of Q: C B^T once per
    group over the lower triangle, and per head its masked product with x,
    the chunk's state and its read-out."""
    nbytes = (4 * B * S * H * P * 2 + 4 * B * S * H + 2 * 2 * B * S * G * N
              + 4 * B * H * P * N)
    tri = Q * (Q + 1) // 2
    flops = B * (S // Q) * (G * 2 * tri * N
                            + H * (2 * tri * P + 4 * Q * P * N))
    return nbytes, flops


def k5(B: int, H: int, K: int, D: int, n_valid: int, Mf: int, Ms: int,
       elem: int = 2):
    """Tiered paged decode attention over both tiers of one layer, one
    step: (bytes, flops). Reads q [B, H, D], the K and V of the
    ``n_valid`` valid tokens, both tiers' page ids and the positions;
    writes the output [B, H, D] and each page's attention mass [B, Mf +
    Ms] in float32; QK^T and PV over the valid tokens."""
    nbytes = (2 * n_valid * K * D * elem + 2 * B * H * D * elem
              + 2 * 4 * B * (Mf + Ms) + 4 * B)
    return nbytes, 4 * H * D * n_valid


# ------------------------------------------------------------- model ----
def attn_params(s: dict) -> int:
    """Weights of one attention block's projections."""
    d, hd = s["d_model"], s["head_dim"]
    return d * hd * (2 * s["num_heads"] + 2 * s["num_kv_heads"])


def mlp_params(s: dict) -> int:
    """Weights of one MLP: SwiGLU's three matrices, or two."""
    return (3 if s.get("act", "silu") == "silu" else 2) * s["d_model"] * s[
        "d_ff"]


def family(s: dict):
    """The reference module of the configuration's model family, which
    counts what its model does (``refs/<family>.py``)."""
    from portbench import refs
    return refs.of(s["family"])


def forward_flops(s: dict, B: int, S: int, logit_rows: int) -> int:
    """Operations of a forward over B x S tokens that computes the logits
    of ``logit_rows`` positions of each sequence: the weight products, the
    causal attention's QK^T and PV, and the family's scan, if it has one."""
    d, V = s["d_model"], s["vocab_size"]
    fam = family(s)
    attn = fam.attention_calls(s) * k7(B, s["num_heads"], s["num_kv_heads"],
                                       s["head_dim"], S,
                                       s.get("sliding_window"))[1]
    return (2 * B * S * fam.token_macs(s) + 2 * B * logit_rows * d * V
            + attn + fam.scan_flops(s, B, S))


def decode_step_flops(s: dict, B: int, position: int) -> int:
    """Operations of one decode step of B sequences at ``position`` (the
    token written is the position-th, counted from 0): the weight products
    and the LM head, attention over the position + 1 tokens each layer
    holds (within the window), and the family's recurrent state, if it has
    one."""
    d, V = s["d_model"], s["vocab_size"]
    fam = family(s)
    ctx = position + 1
    if s.get("sliding_window") is not None:
        ctx = min(ctx, s["sliding_window"])
    attn = fam.attention_calls(s) * 4 * B * s["num_heads"] * s[
        "head_dim"] * ctx
    return 2 * B * (fam.token_macs(s) + d * V) + attn + fam.state_flops(s, B)


def train_step_flops(s: dict, B: int, S: int) -> int:
    """Model operations of one training step: three times the forward's
    (the backward's two products for each of the forward's), logits at
    every position; recomputation is not counted."""
    return 3 * forward_flops(s, B, S, S)
