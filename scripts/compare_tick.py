#!/usr/bin/env python3
"""Time the full-width tiering tick of this checkout against other
checkouts' on one card, in turns, one process per turn.

    git archive <rev> src | tar -x -C old/
    python3 scripts/compare_tick.py --root old=old

The tick is ``chip_smoke.py``'s phases 4 and 7: T=64, L=262,144,
equilibria, impl "cuda", on the bench trace. Each turn is a fresh process
that puts its checkout's ``src`` first on the path and times it with this
checkout's ``chip_smoke.py`` helpers, so only the package under test
differs: the tick's wall time (``tick_ms``: CUDA events around 10 ticks
after a warm-up, three repeats) and, under ``torch.profiler``
(``tick_profile``, 5 ticks), its device events, busy time and the
K3 (``seg_sums``) and K4 (``commit_moves``) device ms per tick. Turns run
the checkouts in order, then in reverse, ``--rounds`` times (``new`` is
this checkout). Prints the card's name and power limit, one line per
turn, then each checkout's median over its turns.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNELS = ("seg_sums", "commit_moves")


def worker(root: pathlib.Path) -> dict:
    """One turn: the tick of the package under ``root/src``."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import TieringConfig
    from repro_torch.core.engine import make_tick
    from repro_torch.core.state import init_state
    import repro_torch
    assert pathlib.Path(repro_torch.__file__).resolve().is_relative_to(
        root.resolve()), repro_torch.__file__
    import numpy as np
    cfg = cs.bench_config(TieringConfig, cs.T0, cs.L0)
    owner, acc, _ = cs.bench_trace(np, cs.T0, cs.L0, 1)
    wall = [cs.tick_ms(torch, make_tick, init_state, cfg, owner, acc[0],
                       "cuda") for _ in range(3)]
    prof = cs.tick_profile(torch, make_tick, init_state, cfg, owner, acc[0],
                           "cuda")
    out = {"wall_ms": wall}
    if prof is not None:
        n_dev, busy, top = prof
        out.update(events=n_dev, busy_ms=busy, **{
            k: sum(t for name, t, _ in top if f"{k}_kernel(" in name)
            for k in KERNELS})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    roots = {"new": ROOT}
    for spec in args.root:
        name, path = spec.split("=", 1)
        roots[name] = pathlib.Path(path).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    order = (list(roots) + list(reversed(roots))) * args.rounds
    runs = {name: [] for name in roots}
    for name in order:
        r = subprocess.run([sys.executable, __file__, "--worker",
                            str(roots[name])], capture_output=True,
                           text=True)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        res = json.loads(r.stdout.strip().splitlines()[-1])
        runs[name].append(res)
        print(f"turn {name}: wall " + " ".join(
            f"{v:.4f}" for v in res["wall_ms"]) + " ms a tick"
            + ("" if "busy_ms" not in res else
               f"; {res['events']:g} device events, busy "
               f"{res['busy_ms']:.4f} ms, " + ", ".join(
                   f"{k} {res[k]:.4f}" for k in KERNELS) + " ms a tick"),
            flush=True)
    for name, rs in runs.items():
        wall = [v for r in rs for v in r["wall_ms"]]
        line = (f"{name}: wall median {statistics.median(wall):.4f} ms "
                f"(min {min(wall):.4f}, max {max(wall):.4f})")
        if all("busy_ms" in r for r in rs):
            line += (f", busy median "
                     f"{statistics.median(r['busy_ms'] for r in rs):.4f} ms, "
                     + ", ".join(f"{k} median "
                                 f"{statistics.median(r[k] for r in rs):.4f}"
                                 for k in KERNELS))
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
