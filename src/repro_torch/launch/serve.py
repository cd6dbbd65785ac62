"""Multi-tenant serving launcher: Equilibria-tiered paged-KV decode (torch
port of the reference's ``launch/serve.py``; every family).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama32_1b \\
      --smoke --tenants 4 --batch 8 --steps 48 --mode equilibria --bound 3 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \\
      --smoke --tenants 4 --batch 8 --steps 48 --mode equilibria --bound 3 \\
      --device cpu

(and ``--arch`` any of ``configs.ARCH_IDS``: granite_moe_3b_a800m,
mixtral_8x22b, codeqwen15_7b, h2o_danube_3_4b, qwen3_32b, mamba2_130m,
whisper_tiny, llama32_vision_90b).

For the encdec (whisper_tiny) and vlm (llama32_vision_90b) families the
launcher leaves the serve state's cross-attention K/V at zeros, as the
reference's launcher does: it has no audio or image frontend, so the
cross-attention reads zero keys and values (its output is zero). A caller
with frames or image embeddings fills ``state["cross_k"]`` and
``state["cross_v"]`` from ``serve.decode.compute_cross_kv``.

Runs a continuous-batching greedy decode loop: every sequence belongs to a
tenant (sequence b to tenant b mod T); the Equilibria policy (lower
protection / upper bound / Eq.1 / Eq.2 / thrash mitigation) manages the
shared fast-tier page budget inside the step. Prints the decode time, the
first step's apart (it builds the kernels and warms the allocator) and the
rate of the steps after it; then the per-tenant cgroup-style ``tier_stat``
counters and the tail of the migration ring; the attention-free ssm family
has no paged KV, so it prints the decode line alone, as the reference's
launcher does.

``--device`` defaults to ``cuda`` and raises without a card. ``--full``
runs the serving load the port is measured at for the arch: the
(sequences, steps) of its config's ``SERVE_LOAD`` (llama32_1b 64 x 512,
zamba2_7b 32 x 256, granite_moe_3b_a800m, mamba2_130m and whisper_tiny
64 x 256, mixtral_8x22b and llama32_vision_90b 16 x 64, the other dense
configs 32 x 64) under
``full_load``'s policy, 4 tenants, 16-token pages, a 256-slot thrash table,
and protections and bounds that are fixed shares of each tenant's quarter
of the fast budget (75% of the logical pages): llama32_1b (320, 256, 128,
0) and (0, 448, 384, 320) pages, zamba2_7b (80, 64, 32, 0) and (0, 112, 96,
80), granite_moe_3b_a800m and whisper_tiny (160, 128, 64, 0) and (0, 224,
192, 160), where
the budget binds; the windowed configs' logical pages cover their window
(4,096 tokens), which the short loads do not fill. The port runs on
one device and builds no mesh, so the reference's ``--production`` (its
production mesh) is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_serve_load, get_smoke_config
from repro_torch.configs.base import ModelConfig, TieringConfig
from repro_torch.device import resolve_device
from repro_torch.memtier.kvcache import kv_layer_count
from repro_torch.models.transformer import make_model
from repro_torch.obs.stats import format_tier_stat, stats_summary
from repro_torch.obs.trace import decode_ring
from repro_torch.serve.decode import (build_serve_step, fast_budget_pages,
                                     init_serve_state)

# Each tenant's lower protection and upper bound in sixths of its even
# quarter of the fast budget (0: unbounded): tenant 0 protected and
# unbounded, tenants 1-3 less protected and bounded at 7/6, 6/6 and 5/6.
PROTECTION_SIXTHS = (5, 4, 2, 0)
BOUND_SIXTHS = (0, 7, 6, 5)
# A page's hotness is the EWMA (decay 0.85) of its share of the sequence's
# attention, a share the pages of one sequence split to 1 every step; the
# steady-state hotness of a page holding share m is m / 0.15, and the even
# share of a full 32-page context gives 0.21. The default threshold, 2.0,
# is the OS simulator's "two accesses per tick": here it needs a page to
# hold 30% of its sequence's attention every step. Under random weights no
# slow page comes near it (on an H100, chip_smoke.py's 512-step run: the
# hottest slow page reached 0.361, the hottest fast page 6.21). 0.25
# promotes a slow page holding 3.75% of the attention, 1.2x the even share
# of a full context.
FULL_PROMO_THRESHOLD = 0.25


def full_load(cfg: ModelConfig, batch: int, steps: int) -> TieringConfig:
    """The measured tiering policy on a ``batch`` x ``steps`` load of
    ``cfg``: 4 tenants, 16-token pages, protections and bounds from
    ``PROTECTION_SIXTHS`` and ``BOUND_SIXTHS`` of each tenant's quarter of
    the fast budget."""
    tcfg = TieringConfig(n_tenants=len(PROTECTION_SIXTHS), page_tokens=16,
                         thrash_table_slots=256,
                         promo_hot_threshold=FULL_PROMO_THRESHOLD)
    if kv_layer_count(cfg) == 0:
        return tcfg                       # no paged KV: no fast budget
    share = fast_budget_pages(cfg, tcfg, batch, steps) // tcfg.n_tenants
    return dataclasses.replace(
        tcfg, lower_protection=tuple(share * s // 6
                                     for s in PROTECTION_SIXTHS),
        upper_bound=tuple(share * s // 6 for s in BOUND_SIXTHS))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the measured serving load (overrides --tenants, "
                         "--batch, --steps, --page-tokens, --protection, "
                         "--bound)")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--page-tokens", type=int, default=4)
    ap.add_argument("--mode", default="equilibria",
                    choices=["equilibria", "tpp", "static"])
    ap.add_argument("--protection", type=int, default=8,
                    help="fast-tier lower protection per tenant (pages)")
    ap.add_argument("--bound", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production:
        ap.error("--production: the port runs on one device and builds no "
                 "mesh")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.full:
        batch, steps = get_serve_load(args.arch)
        tcfg = full_load(cfg, batch, steps)
    else:
        batch, steps = args.batch, args.steps
        tcfg = TieringConfig(
            n_tenants=args.tenants, page_tokens=args.page_tokens,
            thrash_table_slots=256,
            lower_protection=(args.protection,) * args.tenants,
            upper_bound=(args.bound,) * args.tenants)

    model = make_model(cfg, seed=0, device=dev)
    state = init_serve_state(cfg, tcfg, batch, steps, device=dev)
    step = build_serve_step(cfg, tcfg, batch, steps, mode=args.mode,
                            device=dev)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                           dtype=torch.int32).to(dev)
    def done() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    # the first step builds the kernels and warms the allocator: it is
    # timed apart and left out of the rate
    t0 = t1 = time.perf_counter()
    with torch.no_grad():
        for i in range(steps):
            logits, state = step(model, state, tokens)
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            if i == 0:
                t1 = done()
    t2 = done()
    rate = (f"{batch * (steps - 1) / (t2 - t1):.1f} tok/s over the "
            f"{steps - 1} steps after the first" if steps > 1 else
            "no rate: under two steps")
    print(f"arch={cfg.name} mode={args.mode} device={dev} decoded "
          f"{steps} tokens x {batch} seqs in {t2 - t0:.2f}s (first step "
          f"{t1 - t0:.2f}s; {rate})")
    if "kv" in state:
        print_tier_stat(state["kv"], cfg, tcfg)


def print_tier_stat(kv, cfg: ModelConfig, tcfg: TieringConfig) -> None:
    """The per-tenant ``tier_stat`` blocks and the migration ring's tail."""
    tenants = tcfg.n_tenants
    ten = kv.tenant.cpu().numpy()
    fp = (kv.fast_page >= 0).sum(1).cpu().numpy()
    sp = (kv.slow_page >= 0).sum(1).cpu().numpy()
    fast = np.bincount(ten, weights=fp, minlength=tenants).astype(int)
    slow = np.bincount(ten, weights=sp, minlength=tenants).astype(int)
    c = kv.counters
    # one page slot holds k+v for every KV layer (pools are [L, B, Mf, ...])
    page_bytes = (2 * tcfg.page_tokens * cfg.num_kv_heads
                  * cfg.resolved_head_dim * 2 * kv_layer_count(cfg))
    stat = {
        "local_usage_bytes": fast * page_bytes,
        "cxl_usage_bytes": slow * page_bytes,
        "pgpromote": c.promotions, "pgdemote": c.demotions,
        "pgpromote_attempted": c.attempted_promotions,
        "pgalloc": c.allocations, "thrash_events": c.thrash_events,
    }
    summary = stats_summary(kv.stats)
    print("\nper-tenant tier_stat (cgroup-style observability, §IV-C):")
    for t in range(tenants):
        print(f"tenant{t} (promo_scale={float(kv.promo_scale[t]):.3f}):")
        print(format_tier_stat(stat, summary, t))
    events, dropped = decode_ring(kv.ring)
    print(f"\nmigration trace: {len(events)} events buffered "
          f"({dropped} older events overwritten); last 5:")
    for e in events[-5:]:
        d = "promote" if e["direction"] == 0 else "demote"
        print(f"  step={e['tick']} tenant={e['tenant']} "
              f"page={e['page']} {d} hotness={e['hotness']:.3f}")


if __name__ == "__main__":
    main()
