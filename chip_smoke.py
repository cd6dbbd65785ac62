#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each kernel against its plain torch version on the card, drives the
port's main path — the static tiering tick through ``simulate`` /
``run_engine`` — and checks what comes out. Phases, one line each:

  1. device: nvidia-smi name and power limit, torch/CUDA versions, the build
  2. kernels vs plain versions on the card, bitwise, at full width
     (T=64, S=4096, k=256; L=262,144, C=4096, N=16,384) and on edge cases
  3. the reference's ``static_small`` golden through ``simulate(impl="cuda")``
  4. full-width main path: T=64, L=262,144, equilibria, 20 ticks, "cuda" vs
     "ref" on the card; every kernel must launch in this run
  5. ``stacked64`` in all four modes, "cuda" vs "ref"
  6. per-kernel time, launches per tick, bound, plain and library times
  7. where a full-width tick's device time goes (torch.profiler): device
     events per tick, busy time and idle share, the top kernels

Any failure raises (non-zero exit). The last two lines are the kernels'
JSON record and ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA device is present or the port's sources are missing.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden" / "static_small.json"

# full width: the repo's scale point (benchmarks/roofline.py, bench_tick)
T0, L0, K_MAX = 64, 262144, 256
MAIN_TICKS = 20
STACKED_TICKS = 120
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published
F32_OPS_PER_S = 67e12          # H100 SXM float32/int32 outside tensor cores
SOURCE = "src/repro_torch/kernels/csrc/selection.cu"
REPLACES = {
    "seg_topk": "src/repro/kernels/select/kernel.py:69",
    "seg_reduce": "src/repro/kernels/select/kernel.py:126",
    "seg_sums": "src/repro/kernels/select/kernel.py:152",
    "commit_moves": "src/repro/kernels/migrate/kernel.py:135",
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------ timing ----
def device_ms(fn, n: int = 50) -> float:
    """Median device time of ``fn`` over ``n`` launches, each bracketed by
    CUDA events. A sleep kernel runs first so the host enqueues every launch
    before the device reaches them: the events then time back-to-back device
    work, not host launch gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    if hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[n // 2]


def copy_bandwidth() -> float:
    """Bytes/s of a 512 MiB device-to-device ``copy_`` (read + write)."""
    import torch
    n = 1 << 27
    x = torch.empty(n, dtype=torch.float32, device="cuda").fill_(1.0)
    y = torch.empty_like(x)
    ms = device_ms(lambda: y.copy_(x), n=10)
    return 2 * 4 * n / (ms * 1e-3)


# ----------------------------------------------------------- phase 2 ----
def _topk_inputs(rng, T, S, int_rows=0.5, special=0.05):
    import numpy as np
    score = rng.standard_normal((T, S)).astype(np.float32)
    ints = rng.random(T) < int_rows          # integer rows force ties
    score[ints] = rng.integers(-20, 20, (int(ints.sum()), S))
    sp = rng.random((T, S))
    score[sp < special / 3] = np.inf
    score[(sp >= special / 3) & (sp < 2 * special / 3)] = -np.inf
    score[(sp >= 2 * special / 3) & (sp < special)] = np.nan
    valid = rng.random((T, S)) < 0.6
    return score, valid


def check_kernels(torch, np, OPS, REFS):
    """Every kernel wrapper vs its plain version on the card, bitwise."""
    KSEL, KMIG = OPS
    RSEL, RMIG = REFS
    rng = np.random.default_rng(0)
    cuda = "cuda"
    err = {k: 0.0 for k in REPLACES}
    cases = {k: 0 for k in REPLACES}

    def same(name, got, want):
        for g, w in zip(got, want):
            require(g.shape == w.shape and g.dtype == w.dtype,
                    f"{name}: shape/dtype {g.shape} {g.dtype} vs "
                    f"{w.shape} {w.dtype}")
            d = (g.to(torch.float64) - w.to(torch.float64)).abs()
            err[name] = max(err[name], float(d.max()) if d.numel() else 0.0)
            require(torch.equal(g, w), f"{name}: kernel != plain version")
        cases[name] += 1

    # seg_topk: full width, then edge cases (ties, +-inf, NaN, zero and
    # negative quotas, k > S, an all-invalid row)
    topk_cases = []
    score, valid = _topk_inputs(rng, T0, L0 // T0)
    quotas = rng.integers(-4, K_MAX + 40, T0).astype(np.int32)
    quotas[:3] = (0, -1, K_MAX)
    topk_cases.append((score, valid, quotas, K_MAX))
    for (T, S, k) in ((5, 7, 20), (9, 130, 5), (3, 1, 1), (4, 2049, 300)):
        score, valid = _topk_inputs(rng, T, S, special=0.2)
        valid[0] = False
        quotas = rng.integers(-2, S + 3, T).astype(np.int32)
        topk_cases.append((score, valid, quotas, k))
    score = np.zeros((2, 4096), np.float32)          # one big tie
    topk_cases.append((score, np.ones_like(score, bool),
                       np.array([4096, 17], np.int32), 4096))
    for score, valid, quotas, k in topk_cases:
        args = (torch.as_tensor(score, device=cuda),
                torch.as_tensor(valid, device=cuda),
                torch.as_tensor(quotas, device=cuda))
        kk = max(min(k, score.shape[1]), 1)
        same("seg_topk", KSEL.seg_topk(*args, k), RSEL.seg_topk_ref(*args, kk))

    # seg_reduce / seg_sums: full-width 0/1 masks (what the tick feeds) and
    # full-range int32 values whose sums wrap
    S0 = L0 // T0
    xs = [rng.integers(0, 2, (T0, S0)).astype(np.int32),
          rng.integers(-2**31, 2**31, (T0, S0), dtype=np.int64
                       ).astype(np.int32),
          rng.integers(-5, 5, (7, 3000)).astype(np.int32)]
    for x in xs:
        valid = rng.random(x.shape) < 0.7
        a = (torch.as_tensor(x, device=cuda),
             torch.as_tensor(valid, device=cuda))
        same("seg_reduce", KSEL.seg_reduce(*a), RSEL.seg_reduce_ref(*a))
        same("seg_sums", (KSEL.seg_sums(*a),), (RSEL.seg_sums_ref(*a),))

    # commit_moves: full-width stream with more taken lanes than C (ring
    # overflow) and head near 2**31 (wraps), then a small stream
    for (L, C, T, k, p_take, head) in (
            (L0, 4096, T0, K_MAX, 0.4, 2**31 - 1000),
            (L0, 4096, T0, K_MAX, 0.1, 7), (48, 8, 3, 5, 0.5, 2**31 - 3)):
        S = L // T
        cols = np.stack([rng.permutation(S)[:k] for _ in range(T)])
        pages = (np.arange(T)[:, None] * S + cols).astype(np.int32)
        take = rng.random((T, k)) < p_take
        pages = np.where(take, pages, L).reshape(-1).astype(np.int32)
        tenants = np.repeat(np.arange(T, dtype=np.int32), k)
        hot = rng.standard_normal(T * k).astype(np.float32)
        tier = rng.integers(0, 2, L).astype(np.int32)
        ring = rng.integers(-9, 9, (C, 5)).astype(np.int32)

        def run(fn, bits):
            tt = torch.as_tensor(tier, device=cuda)
            rr = torch.as_tensor(ring, device=cuda)
            hh = torch.tensor(head, dtype=torch.int32, device=cuda)
            h = torch.as_tensor(hot, device=cuda)
            return fn(tt, rr, hh, torch.as_tensor(pages, device=cuda),
                      torch.as_tensor(take.reshape(-1), device=cuda),
                      torch.as_tensor(tenants, device=cuda),
                      h.view(torch.int32) if bits else h, 11,
                      direction=1, to_tier=0)
        same("commit_moves", run(KMIG.commit_moves, False),
             run(RMIG.commit_moves_ref, True))
    torch.cuda.synchronize()
    return err, cases


# ----------------------------------------------------------- phase 3 ----
def _events_to_lists(ev) -> list:
    return [[int(e["tick"]), int(e["tenant"]), int(e["page"]),
             int(e["direction"]), round(float(e["hotness"]), 5)] for e in ev]


def collect(r, ring_head: int = 40) -> dict:
    """The telemetry fields the reference's golden fixtures pin (a copy of
    tests/test_golden_trace.py ``_collect``)."""
    ts = r.tier_stats
    return {
        "final_fast_usage": r.fast_usage[-1].tolist(),
        "final_slow_usage": r.slow_usage[-1].tolist(),
        "total_promotions": r.promotions.sum(0).tolist(),
        "total_demotions": r.demotions.sum(0).tolist(),
        "total_attempted": r.attempted.sum(0).tolist(),
        "final_thrash_events": r.thrash_events[-1].tolist(),
        "final_pool_free": int(r.pool_free[-1]),
        "promo_attempts": ts["promo_attempts"].tolist(),
        "promo_success": ts["promo_success"].tolist(),
        "demo_attempts": ts["demo_attempts"].tolist(),
        "demo_success": ts["demo_success"].tolist(),
        "resid_hist": ts["resid_hist"].tolist(),
        "resid_p50": ts["resid_p50"].tolist(),
        "resid_p99": ts["resid_p99"].tolist(),
        "contended_frac": [round(float(x), 6) for x in ts["contended_frac"]],
        "throttled_frac": [round(float(x), 6) for x in ts["throttled_frac"]],
        "below_protection_frac": [round(float(x), 6)
                                  for x in ts["below_protection_frac"]],
        "obs_ticks": int(ts["ticks"]),
        "ring_events_decoded": len(r.migrations),
        "ring_events_dropped": int(r.migrations_dropped),
        "ring_head": _events_to_lists(r.migrations[:ring_head]),
        "ring_tail": _events_to_lists(r.migrations[-ring_head:]),
    }


def diff(got, want, path="") -> None:
    """Exact on ints/strings, atol 1e-4 on floats, recursive on lists."""
    if isinstance(want, list):
        require(isinstance(got, list) and len(got) == len(want),
                f"{path}: length {len(got)} != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            diff(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, str)):
        require(got == want, f"{path}: {got!r} != {want!r}")
    elif isinstance(want, int):
        require(int(got) == want, f"{path}: {got} != {want}")
    elif isinstance(want, float):
        require(abs(float(got) - want) <= 1e-4, f"{path}: {got} != {want}")
    else:
        require(got == want, f"{path}: {got!r} != {want!r}")


# ----------------------------------------------------------- phase 4 ----
def bench_config(TieringConfig, T: int, L: int):
    share = L // (4 * T)
    return TieringConfig(
        n_tenants=T, n_fast_pages=L // 4, n_slow_pages=L,
        lower_protection=(max(share // 2, 1),) * T,
        upper_bound=(2 * share,) * T)


def bench_trace(np, T: int, L: int, ticks: int):
    """bench_tick's inputs: 30% of pages hot (4.0), the rest 0.1, all alive,
    the same every tick."""
    rng = np.random.default_rng(0)
    acc = np.where(rng.random(L) < 0.3, 4.0, 0.1).astype(np.float32)
    owner = np.repeat(np.arange(T, dtype=np.int32), L // T)
    return (owner, np.broadcast_to(acc, (ticks, L)).copy(),
            np.ones((ticks, L), bool))


def state_leaves(state):
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if hasattr(v, "_fields"):
            for g in v._fields:
                out[f"{f}.{g}"] = getattr(v, g)
        elif v is not None:
            out[f] = v
    return out


def compare_runs(torch, a_state, a_out, b_state, b_out, what: str) -> None:
    pairs = {**{f"state.{k}": (v, state_leaves(b_state)[k])
                for k, v in state_leaves(a_state).items()},
             **{f"out.{f}": (getattr(a_out, f), getattr(b_out, f))
                for f in a_out._fields}}
    for name, (x, y) in pairs.items():
        if not torch.is_tensor(x):
            require(x == y, f"{what}: {name} {x} != {y}")
        elif x.is_floating_point():
            require(bool(torch.isfinite(x).all()), f"{what}: {name} finite")
            require(torch.allclose(x, y, rtol=1e-5, atol=1e-4),
                    f"{what}: {name} floats differ")
        else:
            require(torch.equal(x, y), f"{what}: {name} differs")


def tick_ms(torch, make_tick, init_state, cfg, owner, acc, impl,
            n: int = 10) -> float:
    """Mean device-synchronised time of one tick (CUDA events), after a
    warm-up tick, over ``n`` ticks of the bench trace."""
    tick = make_tick(cfg, owner, "equilibria", K_MAX, impl=impl,
                     device="cuda")
    state = init_state(cfg, owner.shape[0], owner=owner, device="cuda")
    a = torch.as_tensor(acc, device="cuda")
    alive = torch.ones_like(a, dtype=torch.bool)
    state, _ = tick(state, (a, alive))
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        state, _ = tick(state, (a, alive))
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def tick_profile(torch, make_tick, init_state, cfg, owner, acc, impl,
                 n: int = 5):
    """Where one tick's device time goes: ``torch.profiler`` over ``n``
    ticks after a warm-up tick. Returns (device events per tick, busy ms per
    tick as the union of their intervals, [(name, ms per tick, count per
    tick)] by total time), or None when the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tick = make_tick(cfg, owner, "equilibria", K_MAX, impl=impl,
                     device="cuda")
    state = init_state(cfg, owner.shape[0], owner=owner, device="cuda")
    a = torch.as_tensor(acc, device="cuda")
    alive = torch.ones_like(a, dtype=torch.bool)
    state, _ = tick(state, (a, alive))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = tick(state, (a, alive))
        torch.cuda.synchronize()
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not dev:
        return None
    busy, end = 0.0, float("-inf")
    by_name: dict = {}
    for s, e, name in dev:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        ms, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (e - s) / 1e3, cnt + 1)
    top = sorted(((k, v[0] / n, v[1] / n) for k, v in by_name.items()),
                 key=lambda r: -r[1])
    return len(dev) / n, busy / 1e3 / n, top


# -------------------------------------------------------------- main ----
def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing next to this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.base import TieringConfig
    from repro_torch.core.engine import make_tick, run_engine
    from repro_torch.core.simulator import simulate, simulate_preset
    from repro_torch.core.state import init_state
    from repro_torch.core.workloads import ci_like, microbenchmark, web_like
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.migrate import ops as KMIG
    from repro_torch.kernels.migrate import ref as RMIG
    from repro_torch.kernels.select import ops as KSEL
    from repro_torch.kernels.select import ref as RSEL

    wrappers = {"seg_topk": KSEL.seg_topk, "seg_reduce": KSEL.seg_reduce,
                "seg_sums": KSEL.seg_sums, "commit_moves": KMIG.commit_moves}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {k: w.launches for k, w in wrappers.items()}

    t_start = time.perf_counter()
    # ---- 1. device + build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("1-device", f"{kind} | torch {torch.__version__} cuda "
                      f"{torch.version.cuda} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = load_library()
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    phase("1-build", f"{lib.path.name} built in {lib.build_s:.1f}s "
                     f"(load {time.perf_counter() - t0:.1f}s); ptxas: "
                     + " | ".join(regs))

    # ---- 2. kernels vs plain versions -------------------------------------
    err, cases = check_kernels(torch, np, (KSEL, KMIG), (RSEL, RMIG))
    phase("2-kernels", "bitwise equal to plain versions: " + ", ".join(
        f"{k} {cases[k]} cases" for k in REPLACES))

    # ---- 3. golden ----------------------------------------------------------
    cfg = TieringConfig(n_tenants=3, n_fast_pages=128, n_slow_pages=256,
                        lower_protection=(48, 48, 0), upper_bound=(0, 64, 0))
    tenants = [microbenchmark(80), web_like(90, arrival=8),
               ci_like(70, phase_len=16)]
    r = simulate(cfg, tenants, 60, k_max=32, impl="cuda", device="cuda")
    want = json.loads(GOLDEN.read_text())
    got = collect(r)
    require(sorted(want) == sorted(got), "golden key set drifted")
    for key in sorted(want):
        diff(got[key], want[key], key)
    phase("3-golden", f"static_small matches {GOLDEN.name} with impl=cuda "
                      f"({len(r.migrations)} ring events)")

    # ---- 4. full-width main path -------------------------------------------
    cfg = bench_config(TieringConfig, T0, L0)
    owner, acc, alive = bench_trace(np, T0, L0, MAIN_TICKS)
    reset_counts()
    a_state, a_out = run_engine(cfg, owner, acc, alive, mode="equilibria",
                                k_max=K_MAX, impl="cuda", device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    b_state, b_out = run_engine(cfg, owner, acc, alive, mode="equilibria",
                                k_max=K_MAX, impl="ref", device="cuda")
    compare_runs(torch, a_state, a_out, b_state, b_out, "full width")
    promos = int(a_out.promotions.sum())
    demos = int(a_out.demotions.sum())
    require(promos > 0 and demos > 0, "full width: no migrations")
    require(a_out.fast_usage.shape == (MAIN_TICKS, T0), "output shape")
    for name, n in launches.items():
        require(n > 0, f"main path never launched {name}")
    # in turns, so drift on the card shows as a cuda/cuda spread
    ms = [(impl, tick_ms(torch, make_tick, init_state, cfg, owner, acc[0],
                         impl)) for impl in ("cuda", "ref", "batched", "cuda")]
    phase("4-main", f"T={T0} L={L0} equilibria {MAIN_TICKS} ticks: cuda == "
                    f"ref (ints bitwise, floats rtol 1e-5); promotions "
                    f"{promos} demotions {demos}; launches {launches}; "
                    f"tick ms " + " ".join(f"{k}={v:.4f}" for k, v in ms))

    # ---- 5. stacked64, four modes ------------------------------------------
    res = []
    for mode in ("equilibria", "tpp", "memtis", "static"):
        a = simulate_preset("stacked64", ticks=STACKED_TICKS, mode=mode,
                            impl="cuda", device="cuda")
        b = simulate_preset("stacked64", ticks=STACKED_TICKS, mode=mode,
                            impl="ref", device="cuda")
        for f in ("fast_usage", "slow_usage", "promotions", "demotions",
                  "thrash_events", "attempted", "pool_free"):
            require(np.array_equal(getattr(a, f), getattr(b, f)),
                    f"stacked64 {mode}: {f}")
        require(np.array_equal(a.migrations, b.migrations),
                f"stacked64 {mode}: ring")
        for f in ("throughput", "latency", "promo_scale"):
            require(np.allclose(getattr(a, f), getattr(b, f), rtol=1e-5,
                                atol=1e-4), f"stacked64 {mode}: {f}")
        res.append(f"{mode} moves={int(a.promotions.sum())}"
                   f"+{int(a.demotions.sum())}")
    phase("5-modes", f"stacked64 {STACKED_TICKS} ticks cuda == ref: "
                     + ", ".join(res))

    # ---- 6. per-kernel numbers at full width -------------------------------
    bw = copy_bandwidth()
    rng = np.random.default_rng(1)
    S0 = L0 // T0
    score = torch.as_tensor(
        np.where(rng.random((T0, S0)) < 0.3, 4.0, 0.1).astype(np.float32)
        + rng.random((T0, S0)).astype(np.float32), device="cuda")
    valid = torch.as_tensor(rng.random((T0, S0)) < 0.5, device="cuda")
    quotas = torch.full((T0,), K_MAX, dtype=torch.int32, device="cuda")
    xmask = torch.as_tensor(rng.integers(0, 2, (T0, S0)).astype(np.int32),
                            device="cuda")
    vall = torch.ones((T0, S0), dtype=torch.bool, device="cuda")
    N = T0 * K_MAX
    C = cfg.obs_ring_capacity
    cols = np.stack([rng.permutation(S0)[:K_MAX] for _ in range(T0)])
    take_np = rng.random((T0, K_MAX)) < 0.5
    pages = torch.as_tensor(np.where(
        take_np, np.arange(T0)[:, None] * S0 + cols, L0).reshape(-1)
        .astype(np.int32), device="cuda")
    take = torch.as_tensor(take_np.reshape(-1), device="cuda")
    tenants = torch.arange(T0, dtype=torch.int32, device="cuda"
                           ).repeat_interleave(K_MAX)
    hot = torch.rand(N, device="cuda")
    tier = torch.ones(L0, dtype=torch.int32, device="cuda")
    ring = torch.zeros((C, 5), dtype=torch.int32, device="cuda")
    head = torch.zeros((), dtype=torch.int32, device="cuda")
    n_take = int(take.sum())
    nbytes = {
        "seg_topk": T0 * S0 * 5 + T0 * 4 + T0 * K_MAX * 5 + T0 * 4,
        "seg_reduce": T0 * S0 * 5 + T0 * 4 + T0 * S0 * 4,
        "seg_sums": T0 * S0 * 5 + T0 * 4,
        "commit_moves": N * 13 + 4 + n_take * 4 + min(n_take, C) * 20 + 4,
    }
    nops = {"seg_topk": T0 * S0, "seg_reduce": T0 * S0, "seg_sums": T0 * S0,
            "commit_moves": N}
    kern = {
        "seg_topk": lambda: KSEL.seg_topk(score, valid, quotas, K_MAX),
        "seg_reduce": lambda: KSEL.seg_reduce(xmask, vall),
        "seg_sums": lambda: KSEL.seg_sums(xmask, vall),
        "commit_moves": lambda: KMIG.commit_moves(
            tier, ring, head, pages, take, tenants, hot, 5, direction=0,
            to_tier=0),
    }
    hot_bits = hot.view(torch.int32)
    plain = {
        "seg_topk": lambda: RSEL.seg_topk_ref(score, valid, quotas, K_MAX),
        "seg_reduce": lambda: RSEL.seg_reduce_ref(xmask, vall),
        "seg_sums": lambda: RSEL.seg_sums_ref(xmask, vall),
        "commit_moves": lambda: RMIG.commit_moves_ref(
            tier, ring, head, pages, take, tenants, hot_bits, 5,
            direction=0, to_tier=0),
    }
    library = {
        "seg_topk": lambda: torch.sort(score, dim=1, descending=True,
                                       stable=True)[0][:, :K_MAX],
        "seg_reduce": lambda: torch.cumsum(xmask, dim=1, dtype=torch.int32),
        "seg_sums": lambda: xmask.sum(dim=1, dtype=torch.int32),
        "commit_moves": None,
    }
    rows = []
    for name in REPLACES:
        k_ms = device_ms(kern[name])
        p_ms = device_ms(plain[name])
        lib_ms = device_ms(library[name]) if library[name] else None
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = nops[name] / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "launches_per_tick": launches[name] / MAIN_TICKS,
            "bytes": nbytes[name],
            "bound_copy_ms": nbytes[name] / bw * 1e3,
        })
        phase("6-kernel", f"{name}: {k_ms:.4f} ms (plain {p_ms:.4f}, "
                          f"library {lib_ms if lib_ms is None else f'{lib_ms:.4f}'}"
                          f", bound {rows[-1]['bound_ms']:.5f} at 3.35 TB/s, "
                          f"{rows[-1]['bound_copy_ms']:.5f} at measured copy "
                          f"{bw / 1e12:.3f} TB/s) launches/tick "
                          f"{launches[name] / MAIN_TICKS:g}")

    # ---- 7. where a full-width tick's device time goes --------------------
    tick_cuda_ms = sum(v for k, v in ms if k == "cuda") / 2
    prof = tick_profile(torch, make_tick, init_state, cfg, owner, acc[0],
                        "cuda")
    if prof is None:
        phase("7-profile", "device time not measured: the profiler saw no "
                           "device event")
    else:
        n_dev, busy_ms, top = prof
        ours = {k: [(t, c) for name, t, c in top if f"{k}_kernel(" in name]
                for k in REPLACES}
        phase("7-profile", f"impl=cuda tick: {n_dev:g} device events/tick, "
                           f"busy {busy_ms:.4f} ms of {tick_cuda_ms:.4f} ms "
                           f"(idle share {1 - busy_ms / tick_cuda_ms:.3f}); "
                           "selection kernels ms/tick: " + ", ".join(
                               f"{k} {sum(t for t, _ in v):.4f} "
                               f"x{sum(c for _, c in v):g}"
                               for k, v in ours.items())
                           + "; top by device ms/tick: " + "; ".join(
                               f"{name[:70]} {t:.4f} ms x{c:g}"
                               for name, t, c in top[:12]))
    phase("done", f"{time.perf_counter() - t_start:.1f}s on {smi_line}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
