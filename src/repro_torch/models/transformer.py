"""The decoder LMs (torch port of the dense, moe, ssm and hybrid families
of the reference's ``models/transformer.py``).

``DenseLM``, ``MoELM``, ``SSMLM`` and ``HybridLM`` are ``nn.Module``s whose
parameter trees carry the reference's names and layouts: ``embed.tok``
[V, d], ``embed.final_norm`` [d] (plus ``embed.lm_head`` [d, V] when
embeddings are untied) and the layer stack under ``layers`` with a leading
layer axis (``layers.attn.wq`` [L, d, H, D], ...; ``layers.moe.wg``
[L, E, d, f] for the moe family; Mamba2 blocks for the ssm LM and the
hybrid), plus the hybrid's one weight-shared attention block under
``shared`` (no layer axis). ``model.layer(l)`` is layer ``l``'s parameters
as a nested dict of views, the reference's ``tree_map(lambda a: a[l], ...)``.

``lm_forward`` (dense and moe), ``ssm_lm_forward`` and ``hybrid_forward``
are the full-sequence forwards: every self-attention goes through the
``flash_attention`` op (K7) and every Mamba2 block through the ``ssd_scan``
op (K8), or straight to their plain versions with ``impl="ref"``. The decode block takes an ``attend``
callback so the serving path (``serve/decode.py``) owns the tiered paged
cache.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import (ParamSpec, dtype_of, empty_params,
                                       init_params, stack_specs)


def embed_specs(cfg: ModelConfig) -> Dict:
    specs = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), init="embed"),
             "final_norm": ParamSpec((cfg.d_model,), init="ones")}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size))
    return specs


def attention_specs(cfg: ModelConfig) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kh = cfg.num_heads, cfg.num_kv_heads
    attn = {"wq": ParamSpec((d, h, hd)), "wk": ParamSpec((d, kh, hd)),
            "wv": ParamSpec((d, kh, hd)), "wo": ParamSpec((h, hd, d))}
    if cfg.qk_norm:
        attn["q_norm"] = ParamSpec((hd,), init="ones")
        attn["k_norm"] = ParamSpec((hd,), init="ones")
    return attn


def mlp_specs(cfg: ModelConfig) -> Dict:
    if cfg.act != "silu":
        raise NotImplementedError("only the SwiGLU MLP is ported")
    d = cfg.d_model
    return {"wg": ParamSpec((d, cfg.d_ff)), "wu": ParamSpec((d, cfg.d_ff)),
            "wd": ParamSpec((cfg.d_ff, d))}


def decoder_block_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    specs = {"ln1": ParamSpec((d,), init="ones"),
             "attn": attention_specs(cfg), "ln2": ParamSpec((d,), init="ones")}
    if cfg.family == "moe":
        specs["moe"] = L.moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(cfg)
    return specs


def lm_specs(cfg: ModelConfig) -> Dict:
    return {"embed": embed_specs(cfg),
            "layers": stack_specs(decoder_block_specs(cfg), cfg.num_layers)}


def ssm_lm_specs(cfg: ModelConfig) -> Dict:
    return {"embed": embed_specs(cfg),
            "layers": stack_specs(S.mamba_specs(cfg), cfg.num_layers)}


def hybrid_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    shared = {
        "in_proj": ParamSpec((2 * d, d)),
        "ln1": ParamSpec((d,), init="ones"),
        "attn": attention_specs(cfg),
        "ln2": ParamSpec((d,), init="ones"),
        "mlp": mlp_specs(cfg),
        "out_proj": ParamSpec((d, d), init="small"),
    }
    return {"embed": embed_specs(cfg),
            "layers": stack_specs(S.mamba_specs(cfg), cfg.num_layers),
            "shared": shared}


# families the port runs, and what is still to port
FAMILIES = ("dense", "moe", "ssm", "hybrid")
UNPORTED = ("encdec", "vlm")


def _require_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported: the port runs "
            f"{', '.join(FAMILIES)}; {', '.join(UNPORTED)} are still to port")


def model_specs(cfg: ModelConfig) -> Dict:
    _require_family(cfg)
    return {"dense": lm_specs, "moe": lm_specs, "ssm": ssm_lm_specs,
            "hybrid": hybrid_specs}[cfg.family](cfg)


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

    def tree(self) -> Dict:
        """The parameters as a nested dict of tensors."""
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out

    def index(self, i: int) -> Dict:
        """Entry ``i`` of the leading axis of every tensor, as a nested dict
        of views."""
        out = {k: p[i] for k, p in self._parameters.items()}
        out.update({k: m.index(i) for k, m in self._modules.items()})
        return out


class _LM(nn.Module):
    """A model of family ``FAMILY`` at ``cfg``'s widths, weights in
    ``cfg.param_dtype``, one ``ParamTree`` per top-level subtree of its
    specs.

    ``seed`` draws the weights by the reference's init rules from a
    ``torch.Generator`` on ``device``; ``seed=None`` leaves them
    uninitialised for ``convert.params_from_numpy`` to fill."""

    FAMILY = ""

    def __init__(self, cfg: ModelConfig, *, seed: Optional[int] = 0,
                 device="cuda"):
        super().__init__()
        _require_family(cfg)
        if cfg.family != self.FAMILY:
            raise ValueError(f"{type(self).__name__} is the {self.FAMILY} "
                             f"family, not {cfg.family!r}: use make_model")
        dev = resolve_device(device)
        specs = model_specs(cfg)
        dt = dtype_of(cfg.param_dtype)
        if seed is None:
            tree = empty_params(specs, dev, dt)
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            tree = init_params(specs, gen, dev, dt)
        self.cfg = cfg
        for k, v in tree.items():
            self.add_module(k, ParamTree(v))

    def layer(self, i: int) -> Dict:
        return self.layers.index(i)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return model_forward(self, {"tokens": tokens})


class DenseLM(_LM):
    """Dense decoder LM (``embed``, ``layers``)."""
    FAMILY = "dense"


class MoELM(_LM):
    """Mixture-of-experts decoder LM (``embed``, ``layers`` with a ``moe``
    subtree in place of ``mlp``)."""
    FAMILY = "moe"


class SSMLM(_LM):
    """Attention-free Mamba2 LM (``embed``, ``layers`` of Mamba2 blocks)."""
    FAMILY = "ssm"


class HybridLM(_LM):
    """Zamba2-style hybrid (``embed``, ``layers`` of Mamba2 blocks, and the
    weight-shared attention block ``shared``)."""
    FAMILY = "hybrid"


def make_model(cfg: ModelConfig, *, seed: Optional[int] = 0,
               device="cuda") -> _LM:
    """The model class of ``cfg``'s family."""
    _require_family(cfg)
    cls = {"dense": DenseLM, "moe": MoELM, "ssm": SSMLM,
           "hybrid": HybridLM}[cfg.family]
    return cls(cfg, seed=seed, device=device)


def embed_tokens(model: _LM, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return model.embed["tok"][tokens.to(torch.int64)].to(dtype_of(cfg.dtype))


def lm_logits(model: _LM, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    x = L.rms_norm(x, model.embed["final_norm"], cfg.rms_eps)
    dt = dtype_of(cfg.dtype)
    if cfg.tie_embeddings:
        return x @ model.embed["tok"].to(dt).T
    return x @ model.embed["lm_head"].to(dt)


def decoder_block(p, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, impl: str = "cuda"):
    """Pre-norm full-sequence block; causal attention through K7. Returns
    (x, the MoE aux loss: 0 for the dense family)."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.self_attention(p["attn"], h, cfg, positions, causal=True,
                             window=cfg.sliding_window, impl=impl)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    if cfg.family == "moe":
        y, aux = L.moe_block(p["moe"], h, cfg)
    else:
        y, aux = L.mlp(p["mlp"], h, cfg), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    return x + y, aux


def decoder_block_decode(p, x: torch.Tensor, cfg: ModelConfig,
                         positions: torch.Tensor,
                         attend: Callable) -> torch.Tensor:
    """Decode block; ``attend(q, k_new, v_new) -> attn [B,1,H,D]`` owns the
    cache."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    q, k, v = L.attention_qkv(p["attn"], h, cfg, positions)
    x = x + L.attention_out(p["attn"], attend(q, k, v), cfg)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    if cfg.family == "moe":
        return x + L.moe_block_decode(p["moe"], h, cfg)
    return x + L.mlp(p["mlp"], h, cfg)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[1], device=tokens.device
                        ).expand(tokens.shape)


def _logits(model: _LM, x: torch.Tensor, last_only: bool) -> torch.Tensor:
    return lm_logits(model, x[:, -1:] if last_only else x, model.cfg)


def lm_forward(model: _LM, tokens: torch.Tensor, *, impl: str = "cuda",
               last_only: bool = False, return_aux: bool = False):
    """Dense or moe LM: tokens [B,S] -> logits [B,S,V] ([B,1,V] with
    ``last_only``: the logits are row-wise, so the last position's need no
    other row); with ``return_aux``, (logits, the MoE aux loss summed over
    layers), as the reference's ``lm_forward`` returns them."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, cfg)
    positions = _positions(tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = decoder_block(model.layer(i), x, cfg, positions, impl)
        aux = aux + a
    logits = _logits(model, x, last_only)
    return (logits, aux) if return_aux else logits


def ssm_lm_forward(model: SSMLM, tokens: torch.Tensor, *,
                   impl: str = "cuda", last_only: bool = False
                   ) -> torch.Tensor:
    """Mamba2 LM: tokens [B,S] -> logits [B,S,V] ([B,1,V] with
    ``last_only``); every block's scan through K8."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, cfg)
    for i in range(cfg.num_layers):
        x, _ = S.mamba_block(model.layer(i), x, cfg, impl=impl)
    return _logits(model, x, last_only)


def shared_attn_block(sp, x: torch.Tensor, emb0: torch.Tensor,
                      cfg: ModelConfig, attention: Callable) -> torch.Tensor:
    """One application of the hybrid's shared block on concat(hidden,
    embeddings). ``attention(p, a) -> [B,S,d]`` is the attention body:
    ``L.self_attention`` in the full-sequence forward, ``cached_attention``
    in decode."""
    dt = dtype_of(cfg.dtype)
    h = torch.cat([x, emb0], dim=-1) @ sp["in_proj"].to(dt)
    h = h + attention(sp["attn"], L.rms_norm(h, sp["ln1"], cfg.rms_eps))
    h = h + L.mlp(sp["mlp"], L.rms_norm(h, sp["ln2"], cfg.rms_eps), cfg)
    return x + h @ sp["out_proj"].to(dt)


def cached_attention(cfg: ModelConfig, positions: torch.Tensor,
                     attend: Callable) -> Callable:
    """The decode attention body for ``shared_attn_block``: ``attend(q,
    k_new, v_new) -> attn [B,1,H,D]`` owns the cache."""
    def attention(p, a):
        q, k, v = L.attention_qkv(p, a, cfg, positions)
        return L.attention_out(p, attend(q, k, v), cfg)
    return attention


def hybrid_forward(model: HybridLM, tokens: torch.Tensor, *,
                   impl: str = "cuda", last_only: bool = False
                   ) -> torch.Tensor:
    """Zamba2-style: Mamba2 backbone, one *shared* attention block applied
    before every ``hybrid_attn_every``-th layer on concat(hidden,
    embeddings). The reference's ``lax.cond(idx % every == 0)`` is a branch
    on the host layer index."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, cfg)
    emb0 = x
    positions = _positions(tokens)
    sp = model.shared.tree()

    def attention(p, a):
        return L.self_attention(p, a, cfg, positions, causal=True,
                                window=cfg.sliding_window, impl=impl)

    for i in range(cfg.num_layers):
        if i % cfg.hybrid_attn_every == 0:
            x = shared_attn_block(sp, x, emb0, cfg, attention)
        x, _ = S.mamba_block(model.layer(i), x, cfg, impl=impl)
    return _logits(model, x, last_only)


def model_forward(model: _LM, batch: Dict[str, torch.Tensor], *,
                  impl: str = "cuda", last_only: bool = False
                  ) -> torch.Tensor:
    """Unified full-sequence forward of the ported families. batch:
    {"tokens": [B,S]}. Returns logits [B,S,V] ([B,1,V] with
    ``last_only``)."""
    cfg = model.cfg
    _require_family(cfg)
    fwd = {"dense": lm_forward, "moe": lm_forward, "ssm": ssm_lm_forward,
           "hybrid": hybrid_forward}[cfg.family]
    return fwd(model, batch["tokens"], impl=impl, last_only=last_only)
