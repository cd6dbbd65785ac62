#!/usr/bin/env python3
"""K1's long route (``csrc/selection.cu`` ``seg_topk_long_kernel``) at its
cluster size of 2 blocks a row beside the same source built with clusters
of 4 and of 8, on one card.

    python3 scripts/k1_long_variants.py

Records the seg_topk calls of tick 10 of H1 (``chip_smoke.h1_roster``: 64
slots over 261,824 pages, the call ``chip_smoke.py`` phase 22 times) and
times, on its largest call (T=64), on its first 4 rows and its first row
at quota > 0 (T=4, T=1) and on a dense row (T=1, S=262,144, 60% valid,
quota 256), each build's launch, held bitwise against the plain version.
A variant differs from the committed source in the one line that sets
``kLongCluster``; each is built with ``kernels/build.py`` ``build_variant``
into ``.kernel_build/``.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/selection.cu"
CLUSTER_LINE = "constexpr int kLongCluster = 2;"


def forced_cluster(src: str, cs: int) -> str:
    """The source with the long route's cluster size set to ``cs``."""
    if src.count(CLUSTER_LINE) != 1:
        raise SystemExit(f"k1_long_variants: {CLUSTER_LINE!r} not found once")
    return src.replace(CLUSTER_LINE, f"constexpr int kLongCluster = {cs};")


def h1_calls(torch):
    """The seg_topk calls of H1's tick 10 (cuda), recorded on the way in."""
    import chip_smoke as CS
    from repro_torch.core import simulator as SIM
    from repro_torch.core.churn import make_churn_tick
    from repro_torch.core.state import init_state
    from repro_torch.core.workloads import build_churn_schedule
    from repro_torch.kernels.select import ops as KSEL
    slots = CS.h1_roster(CS.H1_TICKS)
    cfg = SIM.churn_roster_config(slots)
    sched = build_churn_schedule(slots, CS.H1_TICKS)
    L = cfg.n_fast_pages + cfg.n_slow_pages
    calls = []
    orig = KSEL.seg_topk

    def recording(score, valid, quotas, k):
        calls.append((score.clone(), valid.clone(), quotas.clone(), k))
        return orig(score, valid, quotas, k)

    recording.launches = 0
    KSEL.seg_topk = recording
    try:
        tick = make_churn_tick(cfg, L, k_max=CS.K_MAX, impl="cuda",
                               device="cuda")
        state = init_state(cfg, L, device="cuda")
        for t in range(11):
            calls.clear()
            state, _ = tick(state, (
                torch.as_tensor(sched.rates[t], device="cuda"),
                torch.as_tensor(sched.want[t], device="cuda")))
    finally:
        KSEL.seg_topk = orig
    return calls


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_long_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels.build import BUILD_DIR, build_variant
    from repro_torch.kernels.select import ref as RSEL
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    libs = {2: build_variant("selection", SOURCE)}
    for cs in (4, 8):
        path = BUILD_DIR / f"k1_long_cluster{cs}.cu"
        path.write_text(forced_cluster(src, cs))
        libs[cs] = build_variant("selection", path)
    calls = h1_calls(torch)
    score, valid, quotas, k = max(calls, key=lambda c: int(
        c[2].clamp(min=0).sum()))
    active = torch.nonzero(quotas > 0).flatten()
    rng = np.random.default_rng(1)
    dense_s = torch.as_tensor(rng.standard_normal((1, 262144)).astype(
        np.float32), device="cuda")
    dense_v = torch.as_tensor(rng.random((1, 262144)) < 0.6, device="cuda")
    cases = {
        "H1 call (T=64)": (score, valid, quotas),
        "its first 4 rows at quota > 0 (T=4)": tuple(
            a[active[:4]].contiguous() for a in (score, valid, quotas)),
        "its first row at quota > 0 (T=1)": tuple(
            a[active[:1]].contiguous() for a in (score, valid, quotas)),
        "dense row, 60% valid, quota 256 (T=1)": (
            dense_s, dense_v, torch.tensor([256], dtype=torch.int32,
                                           device="cuda")),
    }

    def launch(lib, sc, v, q):
        T, S = sc.shape
        cols = torch.empty((T, k), dtype=torch.int32, device="cuda")
        take = torch.empty((T, k), dtype=torch.bool, device="cuda")
        counts = torch.empty((T,), dtype=torch.int32, device="cuda")
        route = ctypes.c_int(-1)
        err = lib.seg_topk_launch(
            sc.data_ptr(), v.data_ptr(), q.data_ptr(), T, S, k,
            cols.data_ptr(), take.data_ptr(), counts.data_ptr(),
            ctypes.byref(route), torch.cuda.current_stream().cuda_stream)
        if err or route.value != 1:
            raise RuntimeError(f"seg_topk_launch: error {err}, route "
                               f"{route.value}")
        return cols, take, counts

    print(f"H1 tick 10's largest seg_topk call: T={score.shape[0]} "
          f"S={score.shape[1]} k={k}, quotas max {int(quotas.max())}, "
          f"{int((quotas <= 0).sum())} rows <= 0, {int(valid.sum())} valid "
          "lanes", flush=True)
    for cname, (sc, v, q) in cases.items():
        want = RSEL.seg_topk_ref(sc, v, q, k)
        line = []
        # in turns: 2, 4, 8, 8, 4, 2
        order = list(libs) + list(libs)[::-1]
        ms = {cs: [] for cs in libs}
        for cs in order:
            fn = lambda lib=libs[cs]: launch(lib, sc, v, q)
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise AssertionError(f"{cname}: clusters of {cs} != plain")
            ms[cs].append(CS.device_ms(fn, n=50))
        for cs, t in ms.items():
            line.append(f"clusters of {cs} {sum(t) / 2:.4f} ({t[0]:.4f}, "
                        f"{t[1]:.4f})")
        print(f"{cname} (ms, each bitwise = plain): " + ", ".join(line),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
