"""Plain reference of the dense decoder the program runs: pre-norm blocks of
causal (optionally windowed) attention and a SwiGLU MLP, untied embeddings.

``params`` is the weight tree the benchmark drew (``embed``: ``tok``,
``final_norm``, ``lm_head``; ``layers``: ``ln1``, ``attn``, ``ln2``,
``mlp`` stacked on a leading layer axis); ``sizes`` is the configuration's
``port`` table.
"""
from __future__ import annotations

import torch

from portbench.refs import common as C


def forward(params, sizes: dict, tokens: torch.Tensor, *,
            mode: str = "float32", last_only: bool = False,
            grad: bool = False) -> torch.Tensor:
    """tokens [B, S] -> float32 logits [B, S, V] ([B, 1, V] with
    ``last_only``). With ``grad`` autograd records, each layer recomputed in
    the backward."""
    C.no_tf32()
    eps = sizes["rms_eps"]
    layers = params["layers"]

    def layer(i, x):
        p = {k: (v[i] if torch.is_tensor(v) else
                 {kk: vv[i] for kk, vv in v.items()})
             for k, v in layers.items()}
        x = x + C.attention_block(p["attn"], C.rms_norm(x, p["ln1"], eps),
                                  sizes, mode, sizes.get("sliding_window"))
        return x + C.mlp(p["mlp"], C.rms_norm(x, p["ln2"], eps), mode)

    with torch.set_grad_enabled(grad):
        x = params["embed"]["tok"][tokens.long()].float()
        for i in range(sizes["num_layers"]):
            x = C.layer_call(grad, layer, i, x)
        if last_only:
            x = x[:, -1:]
        x = C.rms_norm(x, params["embed"]["final_norm"], eps)
        return C.mm(x, params["embed"]["lm_head"], mode)


# ---- the work of the model, counted from its sizes (``portbench/work.py``)
def token_macs(s: dict) -> int:
    """Multiply-adds of the weight products one token passes through,
    without the LM head."""
    from portbench import work
    return s["num_layers"] * (work.attn_params(s) + work.mlp_params(s))


def attention_calls(s: dict) -> int:
    """Causal attention calls in one forward."""
    return s["num_layers"]


def scan_flops(s: dict, B: int, S: int) -> int:
    """No recurrent scan."""
    return 0


def state_flops(s: dict, B: int) -> int:
    """No recurrent state."""
    return 0
