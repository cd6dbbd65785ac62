"""Multi-tenant decode serving with Equilibria-tiered paged KV caches (torch
port of the reference's ``serve/decode.py``, every family).

``build_serve_step(cfg, tcfg, batch, seq)`` returns
``serve_step(model, state, tokens [B,1]) -> (logits [B,1,V], state)``: one
decoded token for every sequence, then the Equilibria tiering step (hotness
from attention mass, Eq.1/Eq.2-regulated migrations, thrash mitigation).
The reference's scan over layers is a Python loop; the KV pools and the
Mamba2 decode state are updated in place (token append, page moves, the
per-layer recurrent state). State is a dict ``{"kv": TieredKVCache}``, plus
``"mamba": MambaCache`` (stacked over layers) for the hybrid, and
``"cross_k"``/``"cross_v"`` (the cross-attention K/V of every cross layer,
precomputed by ``compute_cross_kv`` from the encoder output or the image
embeddings) for the encdec and vlm families; the attention-free ssm family
has no paged KV and no tiering step, only ``{"mamba": MambaCache}``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, TieringConfig
from repro_torch.core.state import make_policy
from repro_torch.device import resolve_device
from repro_torch.memtier import kvcache as KC
from repro_torch.memtier.tiering import MODES, equilibria_kv_step
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as TF
from repro_torch.models.params import dtype_of
from repro_torch.obs.spans import span

IMPLS = ("cuda", "ref")


def _step_span(serve_step):
    """``serve_step`` inside the span ``serve.step``."""
    @functools.wraps(serve_step)
    def step(model, state, tokens: torch.Tensor):
        with span("serve.step"):
            return serve_step(model, state, tokens)
    return step


def fast_budget_pages(cfg: ModelConfig, tcfg: TieringConfig, batch: int,
                      seq: int) -> int:
    """Global fast-tier budget: 75% of the total logical pages."""
    M, _, _ = KC.cache_dims(cfg, seq, tcfg.page_tokens)
    return max(int(batch * M * 0.75), 1)


def init_serve_state(cfg: ModelConfig, tcfg: TieringConfig, batch: int,
                     seq: int, device="cuda") -> Dict[str, object]:
    """The empty serve state of ``batch`` sequences of up to ``seq`` tokens.
    The cross K/V start at zeros ([n_units, B, n_img, K, D] for the vlm,
    [num_layers, B, encoder_seq, K, D] for the encdec); a caller that has
    an encoder output or image embeddings fills them from
    ``compute_cross_kv``."""
    TF.model_specs(cfg)                  # raises for an unknown family
    dev = resolve_device(device)
    state = {}
    if cfg.family != "ssm":
        state["kv"] = KC.init_cache(cfg, tcfg, batch, seq, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        state["mamba"] = S.init_mamba_cache(cfg, batch, cfg.num_layers,
                                            device=dev)
    if cfg.family in ("encdec", "vlm"):
        layers, t = ((cfg.num_layers, cfg.encoder_seq)
                     if cfg.family == "encdec" else
                     (cfg.num_layers // cfg.cross_attn_every,
                      cfg.num_image_tokens))
        shape = (layers, batch, t, cfg.num_kv_heads, cfg.resolved_head_dim)
        for k in ("cross_k", "cross_v"):
            state[k] = torch.zeros(shape, dtype=dtype_of(cfg.dtype),
                                   device=dev)
    return state


def serve_exposition(state: Dict[str, object],
                     prefix: str = "equilibria_kv") -> str:
    """Prometheus text exposition of a serve state's KV tiering counters
    (``obs.export.kv_exposition`` over ``kvcache.kv_tier_counters``).
    Raises ValueError for attention-free states (pure-SSM serving carries
    no paged KV cache to meter)."""
    from repro_torch.obs.export import kv_exposition
    if "kv" not in state:
        raise ValueError("serve state has no tiered KV cache "
                         "(attention-free family)")
    return kv_exposition(state["kv"], prefix=prefix)


def compute_cross_kv(model: TF._LM, cfg: ModelConfig, enc: torch.Tensor):
    """The cross-attention K/V of every cross layer from the encoder output
    (encdec) or the stub image embeddings (vlm). enc [B, T, d]. Returns
    (ck, cv), each [L_cross, B, T, K, D] in the activation dtype."""
    if cfg.family == "encdec":
        xattn = model.decoder["xattn"]            # wk [L, d, K, D]
    elif cfg.family == "vlm":
        xattn = model.units["cross"]["attn"]      # wk [n_units, d, K, D]
    else:
        raise ValueError(f"family {cfg.family!r} has no cross-attention")
    dt = dtype_of(cfg.dtype)
    enc = enc.to(dt)
    return tuple(torch.stack([L._proj(enc, w.to(dt)) for w in xattn[name]])
                 for name in ("wk", "wv"))


def cross_attend(p, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Decode cross-attention against precomputed K/V: x [B,1,d]; ck, cv
    [B,T,K,D]. The reference's plain single-query product
    (``attn_decode``), float32 scores."""
    q = L._proj(x, p["wq"].to(dtype_of(cfg.dtype)))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.rms_eps)
    return L.attention_out(p, L.attn_decode(q, ck, cv), cfg)


def build_serve_step(cfg: ModelConfig, tcfg: TieringConfig, batch: int,
                     seq: int, mode: str = "equilibria",
                     impl: Optional[str] = None, device="cuda"):
    """Returns serve_step(model, state, tokens [B,1]) -> (logits, state).

    impl "cuda" (the default on a card) runs the attention, the page
    moves and the Mamba2 decode state through the hand-written kernels'
    wrappers; "ref" (the default on the CPU) calls their plain versions
    directly, on any device. The step runs under ``torch.no_grad``. Its
    spans (``obs/spans.py``): ``serve.step`` around it, and inside
    ``serve.alloc`` (the page allocation), ``serve.attention`` (each KV
    layer's append and tiered attention), ``serve.mamba`` (each Mamba2
    layer) and ``serve.tiering`` (the tiering step)."""
    TF.model_specs(cfg)                  # raises for an unknown family
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = resolve_device(device)
    if impl is None:
        impl = "cuda" if dev.type == "cuda" else "ref"
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError("impl='cuda' needs a CUDA device; use impl='ref' on "
                         "the CPU")

    def mamba_layer(model, x, mc: S.MambaCache, idx: int):
        """Layer ``idx``'s Mamba2 decode step; its state updated in place:
        the SSM state by the decode-state kernel itself under ``impl``
        "cuda", every other buffer copied back."""
        with span("serve.mamba"):
            cur = S.MambaCache(*(c[idx] for c in mc))
            x, new = S.mamba_decode_step(model.layer(idx), x, cur, cfg,
                                         impl=impl)
            for c, old, n in zip(mc, cur, new):
                if n is not old:
                    c[idx].copy_(n)
        return x

    if cfg.family == "ssm":
        @_step_span
        @torch.no_grad()
        def serve_step(model: TF.SSMLM, state, tokens: torch.Tensor):
            """The reference's ssm branch: no paged KV (its fast budget is
            0) and no tiering step; the only kernel is the decode-state
            kernel of each layer's O(1)-state recurrence."""
            x = TF.embed_tokens(model, tokens, cfg)
            for idx in range(cfg.num_layers):
                x = mamba_layer(model, x, state["mamba"], idx)
            return TF.lm_logits(model, x, cfg), dict(state)

        return serve_step

    policy = make_policy(tcfg, dev)
    budget = fast_budget_pages(cfg, tcfg, batch, seq)
    window = cfg.sliding_window
    n_layers = KC.kv_layer_count(cfg)

    def attend_fn(kv: KC.TieredKVCache, lpage, i: int, masses: list):
        """The ``attend`` callback of KV layer ``i``: append this step's K/V
        in place, attend over both tiers, add the page masses."""
        def attend(q, k, v):
            fk, fv = kv.fast_k[i], kv.fast_v[i]
            sk, sv = kv.slow_k[i], kv.slow_v[i]
            with span("serve.attention"):
                KC.append_token_kv(fk, fv, sk, sv, kv, lpage, k, v)
                out, mf, ms = KC.tiered_paged_attention(
                    q, fk, fv, sk, sv, kv.fast_page, kv.slow_page,
                    kv.seq_len, window=window, impl=impl)
                masses[0] = masses[0] + mf
                masses[1] = masses[1] + ms
            return out
        return attend

    def begin(state, model, tokens):
        with span("serve.alloc"):
            kv, lpage = KC.alloc_page_for_append(state["kv"], tcfg, policy,
                                                 budget)
        masses = [torch.zeros(kv.fast_page.shape, dtype=torch.float32,
                              device=dev),
                  torch.zeros(kv.slow_page.shape, dtype=torch.float32,
                              device=dev)]
        return kv, lpage, masses, TF.embed_tokens(model, tokens, cfg)

    def tiering(kv: KC.TieredKVCache, masses: list):
        with span("serve.tiering"):
            kv = kv._replace(seq_len=kv.seq_len + 1)
            return equilibria_kv_step(kv, masses[0] / n_layers,
                                      masses[1] / n_layers, tcfg, policy,
                                      budget, mode=mode, impl=impl)

    if cfg.family in ("dense", "moe"):
        @_step_span
        @torch.no_grad()
        def serve_step(model: TF._LM, state, tokens: torch.Tensor):
            """Dense and moe (``moe_block_decode`` in place of the MLP)."""
            kv, lpage, masses, x = begin(state, model, tokens)
            pos = kv.seq_len[:, None]
            for i in range(n_layers):
                x = TF.decoder_block_decode(model.layer(i), x, cfg, pos,
                                            attend_fn(kv, lpage, i, masses))
            kv = tiering(kv, masses)
            return TF.lm_logits(model, x, cfg), {**state, "kv": kv}

        return serve_step

    def cross_fn(state, i: int):
        """The decode cross-attention body of cross layer ``i``."""
        ck, cv = state["cross_k"][i], state["cross_v"][i]
        return lambda p, a: cross_attend(p, a, ck, cv, cfg)

    if cfg.family == "encdec":
        @_step_span
        @torch.no_grad()
        def serve_step(model: TF.EncDecLM, state, tokens: torch.Tensor):
            """The reference's encdec branch: each decoder layer attends
            over its tiered KV layer (K5), then over the precomputed cross
            K/V of its layer."""
            kv, lpage, masses, x = begin(state, model, tokens)
            pos = kv.seq_len[:, None]
            for i in range(n_layers):
                x = TF.encdec_dec_block(
                    model.layer(i), x, cfg, TF.cached_attention(
                        cfg, pos, attend_fn(kv, lpage, i, masses)),
                    cross_fn(state, i))
            kv = tiering(kv, masses)
            return TF.lm_logits(model, x, cfg), {**state, "kv": kv}

        return serve_step

    if cfg.family == "vlm":
        n_self = cfg.cross_attn_every - 1

        @_step_span
        @torch.no_grad()
        def serve_step(model: TF.VisionLM, state, tokens: torch.Tensor):
            """The reference's vlm branch: self layer j of unit u uses KV
            layer ``u * (every - 1) + j`` (the reference's reshape of the
            pools to [n_units, every - 1, ...]); each unit ends with its
            gated cross block over the precomputed K/V; the masses are
            divided by the KV layer count ``n_units * (every - 1)``."""
            kv, lpage, masses, x = begin(state, model, tokens)
            pos = kv.seq_len[:, None]
            for u in range(cfg.num_layers // cfg.cross_attn_every):
                up = model.unit(u)
                for j in range(n_self):
                    x = TF.decoder_block_decode(
                        TF.index_tree(up["self"], j), x, cfg, pos,
                        attend_fn(kv, lpage, u * n_self + j, masses))
                x = TF.cross_block(up["cross"], x, cfg, cross_fn(state, u))
            kv = tiering(kv, masses)
            return TF.lm_logits(model, x, cfg), {**state, "kv": kv}

        return serve_step

    every = cfg.hybrid_attn_every

    @_step_span
    @torch.no_grad()
    def serve_step(model: TF.HybridLM, state, tokens: torch.Tensor):
        """The reference's hybrid branch: before every ``every``-th Mamba2
        layer the shared block attends over KV layer ``idx // every`` (a
        branch on the host layer index); the page masses are divided by the
        KV layer count ``num_layers // every + 1``, as the reference
        divides them, not by the number of applications."""
        kv, lpage, masses, x = begin(state, model, tokens)
        emb0 = x
        pos = kv.seq_len[:, None]
        mc: S.MambaCache = state["mamba"]
        sp = model.shared.tree()
        for idx in range(cfg.num_layers):
            if idx % every == 0:
                x = TF.shared_attn_block(
                    sp, x, emb0, cfg, TF.cached_attention(
                        cfg, pos, attend_fn(kv, lpage, idx // every, masses)))
            x = mamba_layer(model, x, mc, idx)
        kv = tiering(kv, masses)
        return TF.lm_logits(model, x, cfg), {**state, "kv": kv}

    return serve_step
