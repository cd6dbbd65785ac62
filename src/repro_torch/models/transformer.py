"""The model stacks (torch port of the reference's ``models/transformer.py``:
the dense, moe, ssm, hybrid, encdec and vlm families).

``DenseLM``, ``MoELM``, ``SSMLM``, ``HybridLM``, ``EncDecLM`` and
``VisionLM`` are ``nn.Module``s whose parameter trees carry the reference's
names and layouts: ``embed.tok`` [V, d], ``embed.final_norm`` [d] (plus
``embed.lm_head`` [d, V] when embeddings are untied) and the layer stack
under ``layers`` with a leading layer axis (``layers.attn.wq`` [L, d, H,
D], ...; ``layers.moe.wg`` [L, E, d, f] for the moe family; Mamba2 blocks
for the ssm LM and the hybrid), plus the hybrid's one weight-shared
attention block under ``shared`` (no layer axis). The encdec model has
``encoder`` and ``decoder`` stacks and ``enc_ln``; the vlm has ``units``,
each (``cross_attn_every`` - 1) self blocks (``units.self``, two stacked
axes [n_units, every - 1, ...]) and one gated cross block
(``units.cross``). ``model.layer(l)`` is layer ``l``'s parameters as a
nested dict of views, the reference's ``tree_map(lambda a: a[l], ...)``.

``lm_forward`` (dense and moe), ``ssm_lm_forward``, ``hybrid_forward``,
``encdec_forward`` and ``vlm_forward`` are the full-sequence forwards:
every self- and cross-attention goes through the ``flash_attention`` op
(K7) and every Mamba2 block through the ``ssd_scan`` op (K8), or straight
to their plain versions with ``impl="ref"``. The reference scans its
stacks (``models/unroll.py`` picks scan or unroll); here every stack is a
Python loop over layers, so that module has no counterpart. Each layer body
is rematerialised by ``remat`` as the reference's ``make_remat`` does it
(``torch.utils.checkpoint`` in place of ``jax.checkpoint``), when autograd
records. The decode blocks take an ``attend`` callback so the serving path
(``serve/decode.py``) owns the tiered paged cache.

Parameters are registered frozen (``requires_grad=False``): serving and the
prefill record no graph, and the training step (``train/step.py``) turns
them trainable. ``cast_params`` is the model's interface over its
parameters cast to the compute dtype, the reference's ``loss_fn`` cast.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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
    """SwiGLU for ``act="silu"``, else the GELU MLP with zero-initialised
    biases."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        return {"wg": ParamSpec((d, f)), "wu": ParamSpec((d, f)),
                "wd": ParamSpec((f, d))}
    return {"w1": ParamSpec((d, f)), "b1": ParamSpec((f,), init="zeros"),
            "w2": ParamSpec((f, d)), "b2": ParamSpec((d,), init="zeros")}


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


def vlm_specs(cfg: ModelConfig) -> Dict:
    """num_layers = self layers + cross layers: ``num_layers //
    cross_attn_every`` units of (every - 1) self blocks and one gated cross
    block, whose scalar gates start at zero."""
    every = cfg.cross_attn_every
    if every <= 1 or cfg.num_layers % every:
        raise ValueError(f"vlm: num_layers {cfg.num_layers} is not a "
                         f"multiple of cross_attn_every {every} > 1")
    d = cfg.d_model
    unit = {"self": stack_specs(decoder_block_specs(cfg), every - 1),
            "cross": {"ln": ParamSpec((d,), init="ones"),
                      "attn": attention_specs(cfg),
                      "gate": ParamSpec((), init="zeros"),
                      "ln2": ParamSpec((d,), init="ones"),
                      "mlp": mlp_specs(cfg),
                      "gate_mlp": ParamSpec((), init="zeros")}}
    return {"embed": embed_specs(cfg),
            "units": stack_specs(unit, cfg.num_layers // every)}


def encdec_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    enc_block = {"ln1": ParamSpec((d,), init="ones"),
                 "attn": attention_specs(cfg),
                 "ln2": ParamSpec((d,), init="ones"), "mlp": mlp_specs(cfg)}
    dec_block = {"ln1": ParamSpec((d,), init="ones"),
                 "attn": attention_specs(cfg),
                 "ln_x": ParamSpec((d,), init="ones"),
                 "xattn": attention_specs(cfg),
                 "ln2": ParamSpec((d,), init="ones"), "mlp": mlp_specs(cfg)}
    return {"embed": embed_specs(cfg),
            "enc_ln": ParamSpec((d,), init="ones"),
            "encoder": stack_specs(enc_block, cfg.encoder_layers),
            "decoder": stack_specs(dec_block, cfg.num_layers)}


_SPECS = {"dense": lm_specs, "moe": lm_specs, "ssm": ssm_lm_specs,
          "hybrid": hybrid_specs, "encdec": encdec_specs, "vlm": vlm_specs}
# the families of the reference's router, all of them ported
FAMILIES = tuple(_SPECS)


def _require_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (the families are "
                         f"{', '.join(FAMILIES)})")


def model_specs(cfg: ModelConfig) -> Dict:
    _require_family(cfg)
    return _SPECS[cfg.family](cfg)


# the matmuls without batch dimensions: the outputs that ``"dots"`` saves
# (the reference's ``dots_with_no_batch_dims_saveable``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def make_remat(body: Callable, policy: str) -> Callable:
    """The reference's ``make_remat`` for one layer body: ``"none"`` keeps
    every activation; ``"dots"`` recomputes all but the weight matmuls'
    outputs (a selective checkpoint); any other policy (``"block"``, and
    the ``"dots_saveable"`` and ``"full"`` that ``TrainConfig`` names, as
    the reference falls through to it) recomputes the whole body in the
    backward. Nothing is recomputed while autograd does not record."""
    if policy == "none":
        return body
    kw = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}
        if policy == "dots" else {})

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return checkpoint(body, *args, use_reentrant=False, **kw)

    return run


def _tree_of(module: nn.Module) -> Dict:
    out = dict(module._parameters)
    out.update({k: m.tree() for k, m in module._modules.items()})
    return out


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
        return _tree_of(self)

    def index(self, i: int) -> Dict:
        """Entry ``i`` of the leading axis of every tensor, as a nested dict
        of views."""
        return index_tree(self.tree(), i)


def index_tree(tree: Dict, i: int) -> Dict:
    """Entry ``i`` of the leading axis of every tensor of a nested dict."""
    return {k: index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


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
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def layer(self, i: int) -> Dict:
        return self.layers.index(i)

    def tree(self) -> Dict:
        """The parameters as a nested dict of tensors (the reference's
        parameter tree)."""
        return _tree_of(self)

    def forward(self, tokens: torch.Tensor, **inputs) -> torch.Tensor:
        """Logits of ``tokens``; ``inputs`` are the batch's ``frames``
        (encdec) or ``image_embeds`` (vlm)."""
        return model_forward(self, {"tokens": tokens, **inputs})


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


class EncDecLM(_LM):
    """Whisper-style encoder-decoder (``embed``, ``encoder``, ``enc_ln``,
    ``decoder``); ``layer(i)`` is decoder layer ``i``."""
    FAMILY = "encdec"

    def layer(self, i: int) -> Dict:
        return self.decoder.index(i)

    def encoder_layer(self, i: int) -> Dict:
        return self.encoder.index(i)


class VisionLM(_LM):
    """Llama-3.2-Vision-style LM (``embed``, ``units``): ``unit(u)`` is unit
    ``u``'s {"self": [every - 1, ...] stacked self blocks, "cross": the
    gated cross block}."""
    FAMILY = "vlm"

    def unit(self, u: int) -> Dict:
        return self.units.index(u)


class TreeView:
    """Read access to a nested dict of tensors as a ``ParamTree`` gives it:
    ``view["wq"]`` or ``view.attn``, ``tree()`` and ``index(i)``."""

    def __init__(self, tree: Dict):
        self._tree = tree

    def __getitem__(self, key: str):
        v = self._tree[key]
        return TreeView(v) if isinstance(v, dict) else v

    def __getattr__(self, key: str):
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def tree(self) -> Dict:
        return self._tree

    def index(self, i: int) -> Dict:
        return index_tree(self._tree, i)


class ModelView(TreeView):
    """A model's interface (``cfg``, ``layer``, ``unit``,
    ``encoder_layer`` and its subtrees) over another tree of its
    parameters, for the forwards of this module."""

    def __init__(self, model: "_LM", tree: Dict):
        super().__init__(tree)
        self.cfg = model.cfg
        self._cls = type(model)

    def layer(self, i: int) -> Dict:
        return self._cls.layer(self, i)

    def encoder_layer(self, i: int) -> Dict:
        return self._cls.encoder_layer(self, i)

    def unit(self, u: int) -> Dict:
        return self._cls.unit(self, u)


def cast_params(model: "_LM", dtype: torch.dtype) -> ModelView:
    """``model`` over its float32 parameters cast to ``dtype`` once, up
    front, as the reference's ``loss_fn`` casts its masters to the compute
    dtype (so every weight, norm scales included, is rounded to it); the
    gradients flow back through the casts to the float32 masters."""
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(dtype) if t.dtype == torch.float32 else t
    return ModelView(model, cast(model.tree()))


_CLASSES = {"dense": DenseLM, "moe": MoELM, "ssm": SSMLM, "hybrid": HybridLM,
            "encdec": EncDecLM, "vlm": VisionLM}


def make_model(cfg: ModelConfig, *, seed: Optional[int] = 0,
               device="cuda") -> _LM:
    """The model class of ``cfg``'s family."""
    _require_family(cfg)
    return _CLASSES[cfg.family](cfg, seed=seed, device=device)


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


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _out(model, x, last_only: bool, return_aux: bool, aux=None):
    """The logits, with the aux loss (0 outside the moe family) when
    ``return_aux``."""
    logits = _logits(model, x, last_only)
    if not return_aux:
        return logits
    return logits, _zero(x) if aux is None else aux


def lm_forward(model: _LM, tokens: torch.Tensor, *, impl: str = "cuda",
               last_only: bool = False, return_aux: bool = False,
               remat: str = "block"):
    """Dense or moe LM: tokens [B,S] -> logits [B,S,V] ([B,1,V] with
    ``last_only``: the logits are row-wise, so the last position's need no
    other row); with ``return_aux``, (logits, the MoE aux loss summed over
    layers), as the reference's ``lm_forward`` returns them."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, cfg)
    positions = _positions(tokens)
    body = make_remat(lambda p, x: decoder_block(p, x, cfg, positions, impl),
                      remat)
    aux = _zero(x)
    for i in range(cfg.num_layers):
        x, a = body(model.layer(i), x)
        aux = aux + a
    return _out(model, x, last_only, return_aux, aux)


def ssm_lm_forward(model: SSMLM, tokens: torch.Tensor, *,
                   impl: str = "cuda", last_only: bool = False,
                   return_aux: bool = False, remat: str = "block"):
    """Mamba2 LM: tokens [B,S] -> logits [B,S,V] ([B,1,V] with
    ``last_only``); every block's scan through K8."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, cfg)
    body = make_remat(lambda p, x: S.mamba_block(p, x, cfg, impl=impl)[0],
                      remat)
    for i in range(cfg.num_layers):
        x = body(model.layer(i), x)
    return _out(model, x, last_only, return_aux)


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
                   impl: str = "cuda", last_only: bool = False,
                   return_aux: bool = False, remat: str = "block"):
    """Zamba2-style: Mamba2 backbone, one *shared* attention block applied
    before every ``hybrid_attn_every``-th layer on concat(hidden,
    embeddings). The reference's ``lax.cond(idx % every == 0)`` is a branch
    on the host layer index, inside the layer body that ``remat`` covers;
    the shared block's gradient sums over its applications."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, cfg)
    emb0 = x
    positions = _positions(tokens)
    sp = model.shared.tree()

    def attention(p, a):
        return L.self_attention(p, a, cfg, positions, causal=True,
                                window=cfg.sliding_window, impl=impl)

    def body(p, x, shared: bool):
        if shared:
            x = shared_attn_block(sp, x, emb0, cfg, attention)
        return S.mamba_block(p, x, cfg, impl=impl)[0]

    body = make_remat(body, remat)
    for i in range(cfg.num_layers):
        x = body(model.layer(i), x, i % cfg.hybrid_attn_every == 0)
    return _out(model, x, last_only, return_aux)


def cross_block(cp, x: torch.Tensor, cfg: ModelConfig,
                attention: Callable) -> torch.Tensor:
    """The vlm's gated cross block. ``attention(p, a) -> [B,S,d]`` is the
    cross-attention body (``L.cross_attention`` in the full-sequence
    forward, against the precomputed K/V in decode). Each gate is
    ``tanh(gate)`` in float32, cast to the activation dtype, then
    multiplied, as the reference casts it."""
    h = L.rms_norm(x, cp["ln"], cfg.rms_eps)
    a = attention(cp["attn"], h)
    x = x + torch.tanh(cp["gate"].to(torch.float32)).to(x.dtype) * a
    h = L.rms_norm(x, cp["ln2"], cfg.rms_eps)
    y = L.mlp(cp["mlp"], h, cfg)
    return x + torch.tanh(cp["gate_mlp"].to(torch.float32)).to(x.dtype) * y


def vlm_forward(model: VisionLM, tokens: torch.Tensor,
                image_embeds: torch.Tensor, *, impl: str = "cuda",
                last_only: bool = False, return_aux: bool = False,
                remat: str = "block"):
    """tokens [B,S]; image_embeds [B, n_img, d] (the stub frontend's patch
    embeddings) -> logits [B,S,V] ([B,1,V] with ``last_only``). Each unit:
    its self blocks (causal K7), then the gated cross block (non-causal K7
    against every image position). ``remat`` covers the self blocks, as
    the reference's covers its ``self_body``."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, cfg)
    positions = _positions(tokens)
    enc = image_embeds.to(dtype_of(cfg.dtype))

    def attention(p, a):
        return L.cross_attention(p, a, enc, cfg, impl=impl)

    body = make_remat(lambda p, x: decoder_block(p, x, cfg, positions, impl),
                      remat)
    aux = _zero(x)
    for u in range(cfg.num_layers // cfg.cross_attn_every):
        up = model.unit(u)
        for j in range(cfg.cross_attn_every - 1):
            x, a = body(index_tree(up["self"], j), x)
            aux = aux + a
        x = cross_block(up["cross"], x, cfg, attention)
    return _out(model, x, last_only, return_aux, aux)


def _sinusoid(seq: int, d: int) -> torch.Tensor:
    """The encoder's [seq, d] position table: computed in float64 by the
    reference's numpy expression and rounded once to float32, so it is
    bitwise the reference's table."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    return torch.from_numpy(np.concatenate(
        [np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32))


def encode_frames(model: EncDecLM, frames: torch.Tensor, *,
                  impl: str = "cuda", remat: str = "block") -> torch.Tensor:
    """frames [B, T_enc, d] (the stub conv frontend's frame embeddings) ->
    the encoder's output [B, T_enc, d]: its blocks (``encoder_block``),
    then ``enc_ln``."""
    cfg = model.cfg
    dt = dtype_of(cfg.dtype)
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model).to(
        device=frames.device, dtype=dt)
    body = make_remat(lambda p, x: encoder_block(p, x, cfg, impl), remat)
    for i in range(cfg.encoder_layers):
        x = body(model.encoder_layer(i), x)
    return L.rms_norm(x, model.enc_ln, cfg.rms_eps)


def encoder_block(p, x: torch.Tensor, cfg: ModelConfig,
                  impl: str = "cuda") -> torch.Tensor:
    """One pre-norm encoder block: non-causal K7 self-attention without
    rope, then the MLP."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.self_attention(p["attn"], h, cfg, None, causal=False,
                             impl=impl)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h, cfg)


def encdec_dec_block(p, x: torch.Tensor, cfg: ModelConfig,
                     self_attention: Callable,
                     cross_attention: Callable) -> torch.Tensor:
    """One decoder block: causal self-attention, cross-attention, MLP, each
    pre-norm. ``self_attention(p, a)`` and ``cross_attention(p, a)`` are
    the bodies (K7 in the full-sequence forward; the tiered cache and the
    precomputed cross K/V in decode)."""
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + self_attention(p["attn"], h)
    h = L.rms_norm(x, p["ln_x"], cfg.rms_eps)
    x = x + cross_attention(p["xattn"], h)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h, cfg)


def encdec_forward(model: EncDecLM, tokens: torch.Tensor,
                   frames: torch.Tensor, *, impl: str = "cuda",
                   last_only: bool = False, return_aux: bool = False,
                   remat: str = "block"):
    """tokens [B,S]; frames [B, T_enc, d] -> logits [B,S,V] ([B,1,V] with
    ``last_only``: the encoder and the cross K/V still cover every
    position). ``remat`` covers each encoder and each decoder block."""
    cfg = model.cfg
    enc = encode_frames(model, frames, impl=impl, remat=remat)
    x = embed_tokens(model, tokens, cfg)
    positions = _positions(tokens)

    def self_attention(p, a):
        return L.self_attention(p, a, cfg, positions, causal=True,
                                impl=impl)

    def cross_attention(p, a):
        return L.cross_attention(p, a, enc, cfg, impl=impl)

    body = make_remat(lambda p, x: encdec_dec_block(
        p, x, cfg, self_attention, cross_attention), remat)
    for i in range(cfg.num_layers):
        x = body(model.layer(i), x)
    return _out(model, x, last_only, return_aux)


def model_forward(model: _LM, batch: Dict[str, torch.Tensor], *,
                  impl: str = "cuda", last_only: bool = False,
                  return_aux: bool = False, remat: str = "block"):
    """Unified full-sequence forward. batch: {"tokens": [B,S]}, plus
    ``frames`` [B, T_enc, d] (encdec) or ``image_embeds`` [B, n_img, d]
    (vlm). Returns logits [B,S,V] ([B,1,V] with ``last_only``); with
    ``return_aux``, (logits, aux) for every family, as the reference's
    ``model_forward`` returns them (aux is the MoE load-balancing loss, 0
    outside the moe family). ``remat`` is the reference's layer-body
    rematerialisation policy (``make_remat``). ``model`` is a model or a
    ``ModelView`` of one."""
    cfg = model.cfg
    _require_family(cfg)
    tokens = batch["tokens"]
    kw = dict(impl=impl, last_only=last_only, return_aux=return_aux,
              remat=remat)
    if cfg.family == "vlm":
        return vlm_forward(model, tokens, batch["image_embeds"], **kw)
    if cfg.family == "encdec":
        return encdec_forward(model, tokens, batch["frames"], **kw)
    fwd = {"dense": lm_forward, "moe": lm_forward, "ssm": ssm_lm_forward,
           "hybrid": hybrid_forward}[cfg.family]
    return fwd(model, tokens, **kw)
