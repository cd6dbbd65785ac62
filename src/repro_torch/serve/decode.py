"""Multi-tenant decode serving with Equilibria-tiered paged KV caches (torch
port of the dense family of the reference's ``serve/decode.py``).

``build_serve_step(cfg, tcfg, batch, seq)`` returns
``serve_step(model, state, tokens [B,1]) -> (logits [B,1,V], state)``: one
decoded token for every sequence, then the Equilibria tiering step (hotness
from attention mass, Eq.1/Eq.2-regulated migrations, thrash mitigation).
The reference's scan over layers is a Python loop; the KV pools are
updated in place (token append and page moves). State is a dict
``{"kv": TieredKVCache}``. Only the dense family is ported; the other
serving families arrive with slice F.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, TieringConfig
from repro_torch.core.state import make_policy
from repro_torch.device import resolve_device
from repro_torch.memtier import kvcache as KC
from repro_torch.memtier.tiering import MODES, equilibria_kv_step
from repro_torch.models import transformer as TF

IMPLS = ("cuda", "ref")


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"serving family {cfg.family!r} is not ported yet (dense only; "
            "moe, encdec, vlm, hybrid and ssm arrive with slice F)")


def fast_budget_pages(cfg: ModelConfig, tcfg: TieringConfig, batch: int,
                      seq: int) -> int:
    """Global fast-tier budget: 75% of the total logical pages."""
    M, _, _ = KC.cache_dims(cfg, seq, tcfg.page_tokens)
    return max(int(batch * M * 0.75), 1)


def init_serve_state(cfg: ModelConfig, tcfg: TieringConfig, batch: int,
                     seq: int, device="cuda") -> Dict[str, object]:
    _require_dense(cfg)
    return {"kv": KC.init_cache(cfg, tcfg, batch, seq, device=device)}


def build_serve_step(cfg: ModelConfig, tcfg: TieringConfig, batch: int,
                     seq: int, mode: str = "equilibria",
                     impl: Optional[str] = None, device="cuda"):
    """Returns serve_step(model, state, tokens [B,1]) -> (logits, state).

    impl "cuda" (the default on a card) runs the attention and the page
    moves through the hand-written kernels' wrappers; "ref" (the default on
    the CPU) calls their plain versions directly, on any device."""
    _require_dense(cfg)
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
    policy = make_policy(tcfg, dev)
    budget = fast_budget_pages(cfg, tcfg, batch, seq)
    window = cfg.sliding_window
    n_layers = KC.kv_layer_count(cfg)

    def serve_step(model: TF.DenseLM, state, tokens: torch.Tensor):
        kv: KC.TieredKVCache = state["kv"]
        kv, lpage = KC.alloc_page_for_append(kv, tcfg, policy, budget)
        x = TF.embed_tokens(model, tokens, cfg)
        pos = kv.seq_len[:, None]
        amf = torch.zeros(kv.fast_page.shape, dtype=torch.float32, device=dev)
        ams = torch.zeros(kv.slow_page.shape, dtype=torch.float32, device=dev)
        for i in range(n_layers):
            def attend(q, k, v, i=i):
                nonlocal amf, ams
                fk, fv = kv.fast_k[i], kv.fast_v[i]
                sk, sv = kv.slow_k[i], kv.slow_v[i]
                KC.append_token_kv(fk, fv, sk, sv, kv, lpage, k, v)
                out, mf, ms = KC.tiered_paged_attention(
                    q, fk, fv, sk, sv, kv.fast_page, kv.slow_page,
                    kv.seq_len, window=window, impl=impl)
                amf, ams = amf + mf, ams + ms
                return out

            x = TF.decoder_block_decode(model.layer(i), x, cfg, pos, attend)
        kv = kv._replace(seq_len=kv.seq_len + 1)
        kv = equilibria_kv_step(kv, amf / n_layers, ams / n_layers, tcfg,
                                policy, budget, mode=mode, impl=impl)
        return TF.lm_logits(model, x, cfg), {**state, "kv": kv}

    return serve_step
