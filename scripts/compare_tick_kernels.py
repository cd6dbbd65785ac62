#!/usr/bin/env python3
"""Time the tick kernels K2 (``seg_reduce``), K3 (``seg_sums``) and K4
(``commit_moves``) of this checkout against other builds of
``csrc/selection.cu``, in one process on one card.

    git archive <rev> src/repro_torch/kernels/csrc/selection.cu | tar -x -C old/
    python3 scripts/compare_tick_kernels.py \\
        --source old=old/src/repro_torch/kernels/csrc/selection.cu

Every source (``--source NAME=PATH``, repeatable; ``new`` is this checkout's
library) is built with the flags of ``kernels/build.py``
(``build_variant``) and called through the same C launchers
(``seg_reduce_launch``, ``seg_sums_launch``, ``commit_moves_launch``,
whose signatures every revision keeps) at C1's widths: K2 and K3 on T=64
rows of S=4,096 0/1 values, all valid (``chip_smoke.py`` phase 6's
inputs), and at T=64, S=4,097 (rows not 16-byte aligned); K4 on the
N=16,384 move stream of L=262,144 pages into a ring of C=4,096 with half
the lanes taken and with none taken (a settled tick). Each build is first
held bitwise against the plain versions; then every case is timed in
turns (the builds in order, then in reverse; each turn the median of
CUDA-event times over 50 back-to-back launches, ``chip_smoke.device_ms``)
beside the launch floor, an empty kernel of this checkout. A case's line
gives each build's median over its turns, then the turns. Prints the
card's name and power limit first.

``--stress LAUNCHES`` instead launches K4 of ``new``, then of each source,
LAUNCHES times back to back on streams of N=16,384 and N=262,144 lanes
with none and half of them taken, and holds the last result of each
against the plain version: a check of the cluster's barrier protocol. A
launch that faults leaves the process's CUDA context unusable, so give one
``--source`` per run to learn which build failed.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

T, S, K_MAX, L, C = 64, 4096, 256, 262144, 4096


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def seg_reduce(lib, x, valid):
    import torch
    from repro_torch.kernels.build import stream_of
    sums = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    prefix = torch.empty_like(x)
    check(lib.seg_reduce_launch(x.data_ptr(), valid.data_ptr(), x.shape[0],
                                x.shape[1], sums.data_ptr(),
                                prefix.data_ptr(), stream_of(x)),
          "seg_reduce_launch")
    return sums, prefix


def seg_sums(lib, x, valid):
    import torch
    from repro_torch.kernels.build import stream_of
    sums = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    check(lib.seg_sums_launch(x.data_ptr(), valid.data_ptr(), x.shape[0],
                              x.shape[1], sums.data_ptr(), stream_of(x)),
          "seg_sums_launch")
    return (sums,)


def commit_moves(lib, tier, ring, head, pages, take, tenants, hot_bits):
    import torch
    from repro_torch.kernels.build import stream_of
    head_out = torch.empty((), dtype=torch.int32, device=tier.device)
    check(lib.commit_moves_launch(
        tier.data_ptr(), tier.shape[0], ring.data_ptr(), ring.shape[0],
        head.data_ptr(), head_out.data_ptr(), pages.data_ptr(),
        take.data_ptr(), tenants.data_ptr(), hot_bits.data_ptr(),
        pages.shape[0], 5, 0, 0, stream_of(tier)), "commit_moves_launch")
    return tier, ring, head_out


def moves_inputs(torch, np, rng, p_take: float, n: int = T * K_MAX):
    """A move stream of ``n`` lanes, ``p_take`` of them taken. At C1's
    n = T k: each tenant's k candidate pages, the sentinel L on the lanes
    not taken; longer streams take distinct pages of all of L."""
    s0 = L // T
    if n == T * K_MAX:
        cols = np.stack([rng.permutation(s0)[:K_MAX] for _ in range(T)])
        cand = (np.arange(T)[:, None] * s0 + cols).reshape(-1)
        owner = np.repeat(np.arange(T), K_MAX)
    else:
        cand = rng.permutation(L)[:n]
        owner = cand // s0
    take = rng.random(n) < p_take
    pages = np.where(take, cand, L)
    dev = "cuda"
    return (torch.ones(L, dtype=torch.int32, device=dev),
            torch.zeros((C, 5), dtype=torch.int32, device=dev),
            torch.tensor(2**31 - 1000, dtype=torch.int32, device=dev),
            torch.as_tensor(pages.astype(np.int32), device=dev),
            torch.as_tensor(take, device=dev),
            torch.as_tensor(owner.astype(np.int32), device=dev),
            torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                            device=dev).view(torch.int32))


def stress(torch, np, libs, launches: int) -> None:
    """K4 of each build ``launches`` times back to back per stream, then
    its last result against the plain version."""
    from repro_torch.kernels.migrate.ref import commit_moves_ref
    rng = np.random.default_rng(2)
    streams = {f"N={n} taken {p:.0%}": moves_inputs(torch, np, rng, p, n)
               for n in (T * K_MAX, L) for p in (0.0, 0.5)}
    for name, lib in libs.items():
        for label, inputs in streams.items():
            want = commit_moves_ref(*[z.clone() for z in inputs], 5,
                                    direction=0, to_tier=0)
            # a repeated commit stores the same values: one copy serves all
            a = [z.clone() for z in inputs]
            for _ in range(launches):
                got = commit_moves(lib, *a)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}: {label} != plain version")
            print(f"stress {name}: {label}: {launches} launches, no fault, "
                  "last result bitwise equal to the plain version",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--stress", type=int, default=0, metavar="LAUNCHES")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_tick_kernels: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import device_ms
    from repro_torch.kernels.build import (build_variant, load_library,
                                           stream_of)
    from repro_torch.kernels.migrate.ref import commit_moves_ref
    from repro_torch.kernels.select.ref import seg_reduce_ref, seg_sums_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    here = load_library("selection")
    libs = {"new": here.lib}
    for spec in args.source:
        name, path = spec.split("=", 1)
        libs[name] = build_variant("selection", pathlib.Path(path))
    if args.stress:
        stress(torch, np, libs, args.stress)
        return 0
    rng = np.random.default_rng(1)
    cases = {}
    for fn in (seg_reduce, seg_sums):
        for s in (S, S + 1):
            x = torch.as_tensor(rng.integers(0, 2, (T, s)).astype(np.int32),
                                device="cuda")
            cases[f"{fn.__name__} T={T} S={s}"] = (
                fn, (x, torch.ones((T, s), dtype=torch.bool,
                                   device="cuda")))
    for p_take in (0.5, 0.0):
        cases[f"commit_moves N={T * K_MAX} taken {p_take:.0%}"] = (
            commit_moves, moves_inputs(torch, np, rng, p_take))
    # bitwise against the plain versions, on fresh copies
    for label, (fn, inputs) in cases.items():
        for name, lib in libs.items():
            a = [z.clone() for z in inputs]
            b = [z.clone() for z in inputs]
            if fn in (seg_reduce, seg_sums):
                ref = (seg_reduce_ref if fn is seg_reduce
                       else lambda x, v: (seg_sums_ref(x, v),))
                want = ref(*b)
                got = fn(lib, *a)
                # full-range values whose sums wrap, on the same rows
                w = torch.as_tensor(rng.integers(
                    -2**31, 2**31, tuple(a[0].shape), dtype=np.int64).astype(
                    np.int32), device="cuda")
                v = torch.as_tensor(rng.random(tuple(a[0].shape)) < 0.5,
                                    device="cuda")
                want += ref(w, v)
                got += fn(lib, w, v)
            else:
                want = commit_moves_ref(*b, 5, direction=0, to_tier=0)
                got = fn(lib, *a)
            torch.cuda.synchronize()
            for g, wv in zip(got, want):
                if not torch.equal(g, wv):
                    raise AssertionError(f"{name}: {label} != plain version")
    print("every build bitwise equal to the plain versions on "
          + ", ".join(cases), flush=True)
    floor = [device_ms(lambda: here.call(
        "empty_launch", stream_of(torch.empty(0, device="cuda"))))]
    order = list(libs) + list(reversed(libs))
    for label, (fn, inputs) in cases.items():
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(device_ms(lambda: fn(libs[name], *inputs)))
        print(f"{label}: " + ", ".join(
            f"{n} {statistics.median(t):.4f} ms (turns "
            + " ".join(f"{v:.4f}" for v in t) + ")"
            for n, t in times.items()), flush=True)
    floor.append(device_ms(lambda: here.call(
        "empty_launch", stream_of(torch.empty(0, device="cuda")))))
    print("launch floor (empty kernel): "
          + " ".join(f"{v:.4f}" for v in floor) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
