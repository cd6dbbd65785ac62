"""Multi-tenant serving launcher: Equilibria-tiered paged-KV decode (torch
port of the reference's ``launch/serve.py``, dense family).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama32_1b \\
      --smoke --tenants 4 --batch 8 --steps 48 --mode equilibria --bound 3 \\
      --device cpu

Runs a continuous-batching greedy decode loop: every sequence belongs to a
tenant (sequence b to tenant b mod T); the Equilibria policy (lower
protection / upper bound / Eq.1 / Eq.2 / thrash mitigation) manages the
shared fast-tier page budget inside the step. Prints the per-tenant
cgroup-style ``tier_stat`` counters and the tail of the migration ring.

``--device`` defaults to ``cuda`` and raises without a card. ``--full``
runs the serving load the port is measured at (``full_load``): 4 tenants,
64 sequences, 512 steps, 16-token pages, protections (320, 256, 128, 0)
and bounds (0, 448, 384, 320) pages, a 256-slot thrash table. The port
runs on one device and builds no mesh, so the reference's
``--production`` (its production mesh) is refused.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TieringConfig
from repro_torch.device import resolve_device
from repro_torch.memtier.kvcache import kv_layer_count
from repro_torch.models.transformer import DenseLM
from repro_torch.obs.stats import format_tier_stat, stats_summary
from repro_torch.obs.trace import decode_ring
from repro_torch.serve.decode import build_serve_step, init_serve_state

FULL_BATCH, FULL_STEPS = 64, 512
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


def full_load() -> TieringConfig:
    """The tiering configuration of the measured serving load."""
    return TieringConfig(
        n_tenants=4, page_tokens=16, thrash_table_slots=256,
        lower_protection=(320, 256, 128, 0), upper_bound=(0, 448, 384, 320),
        promo_hot_threshold=FULL_PROMO_THRESHOLD)


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
        tcfg = full_load()
        tenants, batch, steps = tcfg.n_tenants, FULL_BATCH, FULL_STEPS
    else:
        tenants, batch, steps = args.tenants, args.batch, args.steps
        tcfg = TieringConfig(
            n_tenants=tenants, page_tokens=args.page_tokens,
            thrash_table_slots=256,
            lower_protection=(args.protection,) * tenants,
            upper_bound=(args.bound,) * tenants)

    model = DenseLM(cfg, seed=0, device=dev)
    state = init_serve_state(cfg, tcfg, batch, steps, device=dev)
    step = build_serve_step(cfg, tcfg, batch, steps, mode=args.mode,
                            device=dev)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                           dtype=torch.int32).to(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(steps):
            logits, state = step(model, state, tokens)
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    print(f"arch={cfg.name} mode={args.mode} device={dev} decoded "
          f"{steps} tokens x {batch} seqs in {dt:.2f}s "
          f"({batch * steps / dt:.1f} tok/s)")
    kv = state["kv"]
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
