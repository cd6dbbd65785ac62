"""Tiered multi-tenant decode through the program's serve step.

Batches run back to back: each admits ``batch`` sequences into a fresh serve
state (``init_serve_state``), sequence b of tenant b mod ``tenants``, each
with a prompt of ``prompt_tokens`` token(s) drawn from the seed, and decodes
``decode_tokens`` tokens greedily through ``build_serve_step``'s step, which
runs Equilibria's tiering policy inside every step. Each step ends when its
tokens are on the host, as a server hands them out; a step's time runs from
the end of the step before, so a batch's admission falls in its first step.

The check, once the window has closed: a sample of finished sequences drawn
from the seed is run through the plain reference with their served tokens,
and the widest gap by which a served token's reference logit lies below the
reference's best is held to its limit; the tiering guarantees are read off
the program's state at the end of every batch.
"""
from __future__ import annotations

import math
import time

import torch

from portbench import check, refs, traffic


def tiering_config(tr: dict):
    from repro_torch.configs.base import TieringConfig
    return TieringConfig(
        n_tenants=tr["tenants"], page_tokens=tr["page_tokens"],
        thrash_table_slots=tr["thrash_table_slots"],
        promo_hot_threshold=tr["promo_hot_threshold"],
        lower_protection=tuple(tr["protection"]),
        upper_bound=tuple(tr["bound"]))


def snapshot(kv) -> dict:
    """Host copies of the page tables and counters of a serve state."""
    names = ("fast_page", "slow_page", "page_tier", "page_idx", "seq_len",
             "tenant")
    out = {k: getattr(kv, k).cpu().numpy() for k in names}
    c = kv.counters
    out["migrated"] = int((c.promotions + c.demotions).sum())
    return out


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def run(bench) -> None:
    from repro_torch.memtier.kvcache import cache_dims
    from repro_torch.serve.decode import (build_serve_step,
                                         fast_budget_pages, init_serve_state)
    tr, cfg, dev = bench.cell["traffic"], bench.cfg, bench.device
    B, H, P = tr["batch"], tr["decode_tokens"], tr["prompt_tokens"]
    V = cfg.vocab_size
    seq = P - 1 + H                  # tokens a sequence writes
    tcfg = tiering_config(tr)
    budget = fast_budget_pages(cfg, tcfg, B, seq)
    if budget != tr["fast_budget"]:
        raise ValueError(f"fast budget {budget} != the cell's "
                         f"{tr['fast_budget']}")
    model = bench.model()
    step = build_serve_step(cfg, tcfg, B, seq, mode=tr["mode"], device=dev)

    def admit(stream: str, j: int):
        state = init_serve_state(cfg, tcfg, B, seq, device=dev)
        prompt = traffic.tokens(bench.seed, stream, j, (B, P), V, dev)
        for i in range(P - 1):                      # the prompt's head
            _, state = step(model, state, prompt[:, i:i + 1])
        return state, prompt

    def next_token(state, tok):
        logits, state = step(model, state, tok)
        return state, torch.argmax(logits[:, -1], dim=-1,
                                   keepdim=True).to(torch.int32)

    state, prompt = admit("warmup", 0)
    tok = prompt[:, -1:]
    for _ in range(tr["warmup_steps"]):
        state, tok = next_token(state, tok)
    tok.cpu()
    del state, tok
    bench.tracer.warm()
    bench.setup_done()

    trace_at = set(tr["trace_steps"])
    steps = []              # (position, seconds, traced)
    batches = []            # (prompt [B, P] on host, served [B, n], snapshot)
    t0 = t_prev = time.perf_counter()
    j, closed = 0, False
    while not closed:
        state, prompt = admit("decode", j)
        tok, served = prompt[:, -1:], []
        for i in range(H):
            traced = j == 0 and i in trace_at
            with bench.tracer.span("decode_step", traced,
                                   position=P - 1 + i):
                state, tok = next_token(state, tok)
                served.append(tok.cpu())
                t = time.perf_counter()
            steps.append((P - 1 + i, t - t_prev, traced))
            t_prev = time.perf_counter() if traced else t
            t0 += t_prev - t              # the trace's reduction is not run
            if t - t0 >= bench.seconds:
                closed = True
                break
        bench.attempted += B
        if len(served) == H or j > 0:
            batches.append([prompt.cpu(), torch.cat(served, dim=1),
                            snapshot(state["kv"])])
        else:
            # a first batch the window did not finish is finished now,
            # untimed: its answers are late, not missing
            bench.read_memory_peak()
            while len(served) < H:
                state, tok = next_token(state, served[-1].to(dev))
                served.append(tok.cpu())
            batches.append([prompt.cpu(), torch.cat(served, dim=1),
                            snapshot(state["kv"])])
        del state
        j += 1
    window = t_prev - t0
    if not bench.memory_peak:
        bench.read_memory_peak()
    del step
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    bench.e2e["decode_tokens_per_s"] = B * len(steps) / window
    bench.e2e["decode_step_p95_ms"] = 1e3 * p95([s for _, s, _ in steps])
    M, Mf, Ms = cache_dims(cfg, seq, tcfg.page_tokens)
    bench.record.update(
        steps=steps, batch=B, Mf=Mf, Ms=Ms,
        migrated=sum(b[2]["migrated"] for b in batches),
        migrated_steps=len(steps))

    # ---- the check ----
    finished = [b for b in batches if b[1].shape[1] == H]
    picks = traffic.sample(bench.seed, "check", len(finished) * B,
                           tr["check_sequences"])
    rows = [(finished[k // B], k % B) for k in picks]
    prompts = torch.stack([b[0][r] for b, r in rows])
    served = torch.stack([b[1][r] for b, r in rows])
    inputs = torch.cat([prompts, served[:, :-1]], dim=1).to(dev)
    params = model.tree()
    ref = refs.of(cfg.family)
    logits = ref.forward(params, bench.sizes, inputs)[:, P - 1:]
    bench.compare("served_gap", check.served_gap(logits, served.to(dev)))
    if bench.control:
        low = ref.forward(params, bench.sizes, inputs, mode="fp8")[:, P - 1:]
        bench.record["control_served_gap"] = check.served_gap(
            logits, low.argmax(dim=-1))
    worst: dict = {}
    for b in batches:
        for k, v in check.tiering_violations(
                b[2], tr["fast_budget"], tr["bound"], tcfg.page_tokens).items():
            worst[k] = max(worst.get(k, 0), v)
    for k, v in worst.items():
        bench.compare(k, v)
