"""The dense decoder LM (torch port of the dense family of the reference's
``models/transformer.py``).

``DenseLM`` is an ``nn.Module`` whose parameter tree carries the
reference's names and layouts: ``embed.tok`` [V, d], ``embed.final_norm``
[d] (plus ``embed.lm_head`` [d, V] when embeddings are untied) and the
layer stack under ``layers`` with a leading layer axis (``layers.attn.wq``
[L, d, H, D], ...). ``model.layer(l)`` is layer ``l``'s parameters as a
nested dict of views, the reference's ``tree_map(lambda a: a[l], ...)``.

``lm_forward`` is the full-sequence forward (plain torch, materialised
attention); the decode block takes an ``attend`` callback so the serving
path (``serve/decode.py``) owns the tiered paged cache.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.params import (ParamSpec, dtype_of, empty_params,
                                       init_params, stack_specs)


def embed_specs(cfg: ModelConfig) -> Dict:
    specs = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), init="embed"),
             "final_norm": ParamSpec((cfg.d_model,), init="ones")}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size))
    return specs


def decoder_block_specs(cfg: ModelConfig) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kh = cfg.num_heads, cfg.num_kv_heads
    attn = {"wq": ParamSpec((d, h, hd)), "wk": ParamSpec((d, kh, hd)),
            "wv": ParamSpec((d, kh, hd)), "wo": ParamSpec((h, hd, d))}
    if cfg.qk_norm:
        attn["q_norm"] = ParamSpec((hd,), init="ones")
        attn["k_norm"] = ParamSpec((hd,), init="ones")
    if cfg.act != "silu":
        raise NotImplementedError("only the SwiGLU MLP is ported")
    mlp = {"wg": ParamSpec((d, cfg.d_ff)), "wu": ParamSpec((d, cfg.d_ff)),
           "wd": ParamSpec((cfg.d_ff, d))}
    return {"ln1": ParamSpec((d,), init="ones"), "attn": attn,
            "ln2": ParamSpec((d,), init="ones"), "mlp": mlp}


def lm_specs(cfg: ModelConfig) -> Dict:
    return {"embed": embed_specs(cfg),
            "layers": stack_specs(decoder_block_specs(cfg), cfg.num_layers)}


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: parameter names are the
    reference's tree paths joined by dots; ``tree["wq"]`` reads a child."""

    def __init__(self, tree: Dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def index(self, i: int) -> Dict:
        """Entry ``i`` of the leading axis of every tensor, as a nested dict
        of views."""
        out = {k: p[i] for k, p in self._parameters.items()}
        out.update({k: m.index(i) for k, m in self._modules.items()})
        return out


class DenseLM(nn.Module):
    """Dense decoder LM at ``cfg``'s widths, weights in ``cfg.param_dtype``.

    ``seed`` draws the weights by the reference's init rules from a
    ``torch.Generator`` on ``device``; ``seed=None`` leaves them
    uninitialised for ``convert.params_from_numpy`` to fill."""

    def __init__(self, cfg: ModelConfig, *, seed: Optional[int] = 0,
                 device="cuda"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: only the dense family is ported")
        dev = resolve_device(device)
        specs = lm_specs(cfg)
        dt = dtype_of(cfg.param_dtype)
        if seed is None:
            tree = empty_params(specs, dev, dt)
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            tree = init_params(specs, gen, dev, dt)
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.layers = ParamTree(tree["layers"])

    def layer(self, i: int) -> Dict:
        return self.layers.index(i)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lm_forward(self, tokens)


def embed_tokens(model: DenseLM, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return model.embed["tok"][tokens.to(torch.int64)].to(dtype_of(cfg.dtype))


def lm_logits(model: DenseLM, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    x = L.rms_norm(x, model.embed["final_norm"], cfg.rms_eps)
    dt = dtype_of(cfg.dtype)
    if cfg.tie_embeddings:
        return x @ model.embed["tok"].to(dt).T
    return x @ model.embed["lm_head"].to(dt)


def decoder_block(p, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm full-sequence block (materialised causal attention)."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    q, k, v = L.attention_qkv(p["attn"], h, cfg, positions)
    attn = L.attn_dense(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + L.attention_out(p["attn"], attn, cfg)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h, cfg)


def decoder_block_decode(p, x: torch.Tensor, cfg: ModelConfig,
                         positions: torch.Tensor,
                         attend: Callable) -> torch.Tensor:
    """Decode block; ``attend(q, k_new, v_new) -> attn [B,1,H,D]`` owns the
    cache."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    q, k, v = L.attention_qkv(p["attn"], h, cfg, positions)
    x = x + L.attention_out(p["attn"], attend(q, k, v), cfg)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h, cfg)


def lm_forward(model: DenseLM, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B,S] -> logits [B,S,V]. The reference switches to a chunked
    online-softmax attention above 2048 tokens; the result is the same
    function, and this forward keeps the materialised one at every length."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device
                             ).expand(tokens.shape)
    for i in range(cfg.num_layers):
        x = decoder_block(model.layer(i), x, cfg, positions)
    return lm_logits(model, x, cfg)
