#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all at once), holds each kernel against its plain
torch version on the card, drives the port's two main paths — the static
tiering tick through ``simulate`` / ``run_engine``, and tiered paged-KV
serving of Llama 3.2 1B through ``build_serve_step`` — and checks what
comes out. Phases, one line each, each with its duration:

  1. device: nvidia-smi name and power limit, torch/CUDA versions, the build
  2. tick kernels (K1-K4) vs plain versions on the card, bitwise, at full
     width (T=64, S=4096, k=256; L=262,144, C=4096, N=16,384) and edge cases
  3. the reference's ``static_small`` golden through ``simulate(impl="cuda")``
  4. the tick at full width: T=64, L=262,144, equilibria, 20 ticks, "cuda"
     vs "ref" on the card; every tick kernel must launch in this run
  5. ``stacked64`` in all four modes, "cuda" vs "ref"
  6. tick kernels: time, launches per tick, bound, plain and library times
  7. where a full-width tick's device time goes (torch.profiler)
  8. serving kernels (K5 tiered attention, K6 page migration) vs plain
     versions on the card at full width: K5 in bf16 and f32, window None
     and 40, free slots, mid-page lengths; K6 bitwise in bf16 and f32
  9. serving at full width: Llama 3.2 1B (random weights from a seed), 4
     tenants, 64 sequences, 512 decode steps, equilibria, impl "cuda" vs
     "ref" step by step from a shared state on teacher-forced tokens; then
     tpp and static for 64 steps each; K5 and K6 must launch
 10. decode == full-sequence forward at full width in float32 (TF32 off),
     4 sequences x 128 steps, with pages migrating
 11. serving kernels: time, launches per step, bound, plain, library times
 12. where one decode step's device time goes (torch.profiler)

Any failure raises (non-zero exit). The last lines are the card's name and
power limit, the kernels' JSON record and ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when no CUDA device is present or the
port's sources are missing.
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
SERVE_SOURCE = "src/repro_torch/kernels/csrc/serving.cu"
REPLACES = {
    "seg_topk": "src/repro/kernels/select/kernel.py:69",
    "seg_reduce": "src/repro/kernels/select/kernel.py:126",
    "seg_sums": "src/repro/kernels/select/kernel.py:152",
    "commit_moves": "src/repro/kernels/migrate/kernel.py:135",
}
SERVE_REPLACES = {
    "pool_attention_partial":
        "src/repro/kernels/tiered_attention/kernel.py:99",
    "migrate_pages": "src/repro/kernels/migrate/kernel.py:50",
}
# serving: the measured load (repro_torch.launch.serve.full_load), 16 layers
FWD_BATCH, FWD_STEPS = 4, 128
SIDE_STEPS = 64                # tpp and static
# tolerances, with their reasons
K5_TOL = 1e-4        # K5 vs plain: float32 sums in another order (bf16 K/V
#                      are read exactly, so the same tolerance holds)
# cuda vs ref, one step from a shared state. In bf16 (phase 9) K5's and the
# plain version's last-bit float differences round some attention outputs
# to neighbouring bf16 values; every later layer then scores with
# activations that differ by ~2^-8 relative, and under the very peaked
# softmax of these random weights (scores spread over hundreds) that can
# move a head's attention to another token: logits and page hotness then
# differ by a few percent. In float32 (phase 10) the differences stay at
# float32 rounding.
TOL = {"bf16": {"logit_rtol": 1e-1, "hot_atol": 5e-2},
       "f32": {"logit_rtol": 1e-4, "hot_atol": 1e-4}}
FWD_RTOL = 1e-3      # decode vs forward in float32, relative to max |logit|


_LAST = [time.perf_counter()]


def phase(name: str, msg: str) -> None:
    now = time.perf_counter()
    print(f"[{name}] ({now - _LAST[0]:.1f}s) {msg}", flush=True)
    _LAST[0] = now


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


# ----------------------------------------------------------- phase 8 ----
def _attn_case(np, rng, B, H, K, D, pt, Mp, n_pages):
    """Full-width K5 inputs: pages drawn from ``n_pages`` ids, ~15% of the
    slots free, lengths anywhere inside a page."""
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kv = [rng.standard_normal((B, Mp, pt, K, D)).astype(np.float32)
          for _ in range(2)]
    slot = np.stack([rng.permutation(n_pages)[:Mp] for _ in range(B)])
    slot = np.where(rng.random((B, Mp)) < 0.15, -1, slot).astype(np.int32)
    seq = rng.integers(3 * pt, n_pages * pt, B).astype(np.int32)
    return q, kv[0], kv[1], slot, seq


def check_serve_kernels(torch, np, TA, TA_REF, KMIG, KMIG_REF):
    """K5 and K6 wrappers vs their plain versions on the card at the serving
    path's full-width shapes."""
    rng = np.random.default_rng(8)
    err = {k: 0.0 for k in SERVE_REPLACES}
    cases = {k: 0 for k in SERVE_REPLACES}
    B, H, K, D, pt = 64, 32, 8, 64, 16
    for Mp in (32, 16):                       # fast pool, slow pool
        q, pk, pv, slot, seq = _attn_case(np, rng, B, H, K, D, pt, Mp, 40)
        for dtype in (torch.bfloat16, torch.float32):
            a = [torch.as_tensor(x, device="cuda") for x in
                 (q, pk, pv, slot, seq)]
            a[0] = a[0].to(dtype)
            a[1], a[2] = a[1].to(dtype), a[2].to(dtype)
            for window in (None, 40):
                got = TA.pool_attention_partial(*a, window=window)
                want = TA_REF.pool_attention_partial_ref(*a, window=window)
                for g, w in zip(got, want):
                    require(bool(torch.isfinite(g).all()), "K5: non-finite")
                    d = float((g - w).abs().max())
                    err["pool_attention_partial"] = max(
                        err["pool_attention_partial"], d)
                    require(torch.allclose(g, w, atol=K5_TOL, rtol=K5_TOL),
                            f"K5 Mp={Mp} {dtype} window={window}: max err "
                            f"{d}")
                cases["pool_attention_partial"] += 1
    L, Mf, Ms = 16, 32, 16
    for dtype in (torch.bfloat16, torch.float32):
        src = torch.randn((L, B, Mf, pt, K, D), device="cuda").to(dtype)
        dst0 = torch.randn((L, B, Ms, pt, K, D), device="cuda").to(dtype)
        si = torch.as_tensor(rng.integers(0, Mf, B).astype(np.int32),
                             device="cuda")
        di = torch.as_tensor(rng.integers(0, Ms, B).astype(np.int32),
                             device="cuda")
        sel = torch.as_tensor(rng.random(B) < 0.25, device="cuda")
        same = torch.clamp(si, max=Ms - 1)
        for s_i, d_i, se in ((si, di, sel), (same, same, sel),
                             (si, di, torch.zeros_like(sel))):
            got = KMIG.migrate_pages(src, dst0.clone(), s_i, d_i, se)
            want = KMIG_REF.migrate_pages_ref(src, dst0.clone(), s_i, d_i,
                                              se)
            require(torch.equal(got, want), f"K6 {dtype}: kernel != plain")
            cases["migrate_pages"] += 1
    torch.cuda.synchronize()
    return err, cases


# ----------------------------------------------------------- phase 9 ----
def clone_tree(torch, x):
    """A deep copy of a (nested) NamedTuple of tensors."""
    if torch.is_tensor(x):
        return x.clone()
    if hasattr(x, "_fields"):
        return type(x)(*(clone_tree(torch, v) for v in x))
    return x


def _cache_parts(torch, kv):
    """(integer leaves, float leaves) of a TieredKVCache's metadata, by name;
    the ring's hotness column is float bits."""
    ints, floats = {}, {}
    for f in kv._fields:
        v = getattr(kv, f)
        if f in ("fast_k", "fast_v", "slow_k", "slow_v", "t"):
            continue
        leaves = ({f"{f}.{g}": getattr(v, g) for g in v._fields}
                  if hasattr(v, "_fields") else {f: v})
        for name, x in leaves.items():
            if name == "ring.data":
                ints[name] = x[:, :4]
                floats["ring.hot"] = x[:, 4].contiguous().view(torch.float32)
            elif x.is_floating_point():
                floats[name] = x
            else:
                ints[name] = x
    return ints, floats


def deciding_margin(torch, fused_mul_add, rec, tenant, tcfg) -> float:
    """The smallest gap between the values that decide this step's moves,
    from the plain run's inputs to the tiering step: per sequence the two
    coldest fast pages (demotion source) and the two hottest slow-or-
    demoted pages (promotion source), the hottest slow page against the
    promotion threshold, and per tenant the order of the sequences."""
    fast_hot, slow_hot, fast_used, slow_used, mf, ms = rec
    fh = torch.where(fast_used, fused_mul_add(tcfg.hot_decay, fast_hot, mf),
                     0.0)
    sh = torch.where(slow_used, fused_mul_add(tcfg.hot_decay, slow_hot, ms),
                     0.0)
    cold = torch.where(fast_used, fh, float("inf")).sort(dim=1).values
    hot = torch.cat([torch.where(slow_used, sh, float("-inf")), cold[:, :1]],
                    dim=1).sort(dim=1, descending=True).values
    gaps = [cold[:, 1] - cold[:, 0], hot[:, 0] - hot[:, 1],
            (hot[:, 0] - tcfg.promo_hot_threshold).abs()]
    for vals in (cold[:, 0], hot[:, 0]):
        for t in range(tcfg.n_tenants):
            v = vals[tenant == t].sort().values
            gaps.append(v[1:] - v[:-1])
    g = torch.cat([x[torch.isfinite(x)] for x in gaps])
    return float(g.min()) if g.numel() else float("inf")


def serve_compare(torch, np, ctx, mode: str, steps: int, tol: dict,
                  snapshot_at=None):
    """Decode ``steps`` teacher-forced tokens with impl "cuda", and from a
    copy of the same state before every step the plain "ref" step; compare.
    Integer KV metadata must be bitwise equal, unless the step's deciding
    margin is within ``tol["hot_atol"]`` (an excused near-tie flip); logits
    within ``tol["logit_rtol"]`` of max |logit|, hotness within
    ``tol["hot_atol"]``. Returns the run's numbers, the final cuda state
    and the cuda logits per step."""
    SD, fused_mul_add = ctx["SD"], ctx["fused_mul_add"]
    cfg, tcfg, model, toks = ctx["cfg"], ctx["tcfg"], ctx["model"], \
        ctx["toks"]
    B, seq = toks.shape[0], ctx["steps"]
    step_c = SD.build_serve_step(cfg, tcfg, B, seq, mode=mode, impl="cuda")
    step_r = SD.build_serve_step(cfg, tcfg, B, seq, mode=mode, impl="ref")
    state = SD.init_serve_state(cfg, tcfg, B, seq)
    rec = ctx["rec"]
    out = {"logit_rel": [], "hot_err": [], "float_err": 0.0, "flips": [],
           "snapshot": None, "logits": []}
    e0 = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    e1 = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    with torch.no_grad():
        for i in range(steps):
            if snapshot_at == i:
                out["snapshot"] = {"kv": clone_tree(torch, state["kv"])}
            ref_state = {"kv": clone_tree(torch, state["kv"])}
            tok = toks[:, i:i + 1]
            e0[i].record()
            lc, state = step_c(model, state, tok)
            e1[i].record()
            lr, ref_state = step_r(model, ref_state, tok)
            require(bool(torch.isfinite(lc).all()), f"{mode} step {i}: "
                    "non-finite logits")
            out["logits"].append(lc[:, 0])
            out["slow_hot_max"] = max(out.get("slow_hot_max", 0.0), float(
                state["kv"].slow_hot.max()))
            out["fast_hot_max"] = max(out.get("fast_hot_max", 0.0), float(
                state["kv"].fast_hot.max()))
            out["logit_rel"].append(float(
                (lc.float() - lr.float()).abs().max()
                / lr.float().abs().max()))
            ic, fc = _cache_parts(torch, state["kv"])
            ir, fr = _cache_parts(torch, ref_state["kv"])
            bad = [k for k in ic if not torch.equal(ic[k], ir[k])]
            if bad:
                margin = deciding_margin(torch, fused_mul_add, rec["ref"],
                                         state["kv"].tenant, tcfg)
                out["flips"].append((i, margin, bad))
                continue
            hot = 0.0
            for k in fc:
                d = float((fc[k] - fr[k]).abs().max()) if fc[k].numel() \
                    else 0.0
                if k in ("fast_hot", "slow_hot", "ring.hot"):
                    hot = max(hot, d)
                else:
                    out["float_err"] = max(out["float_err"], d)
            out["hot_err"].append(hot)
    torch.cuda.synchronize()
    out["ms"] = [a.elapsed_time(b) for a, b in zip(e0, e1)]
    out["state"] = state
    return out


def check_compare(np, run, tol: dict, what: str) -> None:
    """Print a ``serve_compare`` run's agreement (max and p99 over steps),
    then raise unless it is within ``tol``."""
    lr = np.asarray(run["logit_rel"])
    he = np.asarray(run["hot_err"] or [0.0])
    flips = [(i, float(f"{m:.3g}")) for i, m, _ in run["flips"]]
    worst = max((m for _, m in flips), default=0.0)
    phase(what, f"cuda vs ref: ints bitwise in {len(lr) - len(flips)} of "
          f"{len(lr)} steps, {len(flips)} near-tie flips excused (largest "
          f"deciding margin {worst:.3g}; first {flips[:5]}); logits rel err "
          f"max {lr.max():.3g} p99 "
          f"{np.quantile(lr, 0.99):.3g} median {np.median(lr):.3g} <= "
          f"{tol['logit_rtol']}; hotness err max {he.max():.3g} p99 "
          f"{np.quantile(he, 0.99):.3g} median {np.median(he):.3g} <= "
          f"{tol['hot_atol']}")
    for i, margin, bad in run["flips"]:
        require(margin <= tol["hot_atol"], f"{what} step {i}: integers "
                f"differ in {bad} with deciding margin {margin:.3g} > "
                f"{tol['hot_atol']}")
    require(lr.max() <= tol["logit_rtol"], f"{what}: logits differ by "
            f"{lr.max():.3g} of max |logit| > {tol['logit_rtol']}")
    require(he.max() <= tol["hot_atol"], f"{what}: hotness differs by "
            f"{he.max():.3g} > {tol['hot_atol']}")
    require(run["float_err"] <= 1e-5, f"{what}: float state differs by "
            f"{run['float_err']:.3g}")


# ----------------------------------------------------------- phase 11 ----
def valid_tokens(torch, slot_page, seq_len, pt) -> int:
    tok = slot_page[:, :, None] * pt + torch.arange(pt,
                                                    device=slot_page.device)
    ok = (slot_page >= 0)[:, :, None] & (tok <= seq_len[:, None, None])
    return int(ok.sum())


def sdpa_inputs(torch, q, pools, pages, seq_len, pt):
    """The valid tokens of both pools gathered into dense [B, K, T, D] K/V
    with a validity mask, for one scaled_dot_product_attention call."""
    ks, vs, oks = [], [], []
    for pk, pv, page in zip(pools[0::2], pools[1::2], pages):
        B, Mp, _, K, D = pk.shape
        ks.append(pk.reshape(B, Mp * pt, K, D))
        vs.append(pv.reshape(B, Mp * pt, K, D))
        tok = page[:, :, None] * pt + torch.arange(pt, device=page.device)
        oks.append(((page >= 0)[:, :, None] & (tok <= seq_len[:, None, None])
                    ).reshape(B, Mp * pt))
    k = torch.cat(ks, 1).transpose(1, 2).contiguous()
    v = torch.cat(vs, 1).transpose(1, 2).contiguous()
    mask = torch.cat(oks, 1)[:, None, None, :]
    return q[:, :, None, :], k, v, mask


def step_profile(torch, step, model, state, tok, n: int = 1):
    """Device events of ``n`` decode steps under torch.profiler: (events
    per step, busy ms per step as the union of their intervals, [(name, ms
    per step, count per step)] by total time), or None without device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(model, state, tok)
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

    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TieringConfig
    from repro_torch.core.engine import make_tick, run_engine
    from repro_torch.core.simulator import simulate, simulate_preset
    from repro_torch.core.state import init_state
    from repro_torch.core.workloads import ci_like, microbenchmark, web_like
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.migrate import ops as KMIG
    from repro_torch.kernels.migrate import ref as RMIG
    from repro_torch.kernels.select import ops as KSEL
    from repro_torch.kernels.select import ref as RSEL
    from repro_torch.kernels.tiered_attention import ops as TA
    from repro_torch.kernels.tiered_attention import ref as TA_REF
    from repro_torch.launch.serve import FULL_BATCH, FULL_STEPS, full_load
    from repro_torch.memtier import kvcache as KC
    from repro_torch.models.transformer import DenseLM, lm_forward
    from repro_torch.numerics import fused_mul_add
    from repro_torch.serve import decode as SD

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
    libs = build_all()
    for lib in libs.values():
        regs = [ln.strip() for ln in lib.log.splitlines()
                if "registers" in ln]
        phase("1-build", f"{lib.path.name} built in {lib.build_s:.1f}s; "
                         "ptxas: " + " | ".join(regs))
    phase("1-build", f"all kernels built and loaded in "
                     f"{time.perf_counter() - t0:.1f}s (one nvcc per source, "
                     "in parallel)")

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
    # ---- 8. serving kernels vs plain versions ------------------------------
    serve_err, serve_cases = check_serve_kernels(torch, np, TA, TA_REF, KMIG,
                                                 RMIG)
    phase("8-serve-kernels", f"pool_attention_partial within {K5_TOL} of "
          f"plain (max abs err {serve_err['pool_attention_partial']:.3g}) "
          f"over {serve_cases['pool_attention_partial']} cases (bf16/f32, "
          f"window None/40, fast/slow pools); migrate_pages bitwise over "
          f"{serve_cases['migrate_pages']} cases (bf16/f32, all-unselected, "
          "src slot == dst slot)")

    # ---- 9. tiered-KV serving at full width --------------------------------
    swrap = {"pool_attention_partial": TA.pool_attention_partial,
             "migrate_pages": KMIG.migrate_pages}
    cfg = get_config("llama32_1b")
    tcfg = full_load()
    B, steps = FULL_BATCH, FULL_STEPS
    torch.cuda.reset_peak_memory_stats()
    model = DenseLM(cfg, seed=0, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, steps)).astype(np.int32), device="cuda")
    rec: dict = {}
    kv_step = SD.equilibria_kv_step

    def recording_kv_step(cache, mf, ms, *args, impl, **kw):
        # the tiering step's inputs, for the deciding margin of a flip
        rec[impl] = (cache.fast_hot, cache.slow_hot, cache.fast_page >= 0,
                     cache.slow_page >= 0, mf, ms)
        return kv_step(cache, mf, ms, *args, impl=impl, **kw)

    SD.equilibria_kv_step = recording_kv_step
    ctx = dict(SD=SD, fused_mul_add=fused_mul_add, cfg=cfg, tcfg=tcfg,
               model=model, toks=toks, steps=steps, rec=rec)
    for w in swrap.values():
        w.launches = 0
    run = serve_compare(torch, np, ctx, "equilibria", steps, TOL["bf16"],
                        snapshot_at=steps // 2)
    serve_launches = {k: w.launches for k, w in swrap.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    kv = run["state"]["kv"]
    promos = int(kv.counters.promotions.sum())
    demos = int(kv.counters.demotions.sum())
    step_ms = sorted(run["ms"])
    mean_ms = sum(step_ms) / len(step_ms)
    fast_use = KC.by_tenant((kv.fast_page >= 0).sum(1, dtype=torch.int32),
                            kv.tenant, tcfg.n_tenants).tolist()
    slow_use = KC.by_tenant((kv.slow_page >= 0).sum(1, dtype=torch.int32),
                            kv.tenant, tcfg.n_tenants).tolist()
    phase("9-serve", f"{cfg.name} 16 layers, {B} seqs x {steps} steps, "
          f"{tcfg.n_tenants} tenants, equilibria, bf16; promotions "
          f"{promos} (attempted "
          f"{int(kv.counters.attempted_promotions.sum())}) demotions "
          f"{demos} (max hotness over the run: slow "
          f"{run['slow_hot_max']:.3g}, fast {run['fast_hot_max']:.3g}, "
          f"threshold {tcfg.promo_hot_threshold}) thrash "
          f"{int(kv.counters.thrash_events.sum())}; launches "
          f"{serve_launches}; step ms mean {mean_ms:.3f} median "
          f"{step_ms[len(step_ms) // 2]:.3f} p90 "
          f"{step_ms[int(len(step_ms) * 0.9)]:.3f} (CUDA events, impl=cuda)"
          f"; decode {B / (mean_ms / 1e3):.1f} tokens/s; peak memory "
          f"{peak_gib:.2f} GiB; fast pages per tenant {fast_use} (budget "
          f"{SD.fast_budget_pages(cfg, tcfg, B, steps)}), slow {slow_use}")
    check_compare(np, run, TOL["bf16"], "9-serve-agree")
    require(promos > 0 and demos > 0, f"serving: promotions {promos}, "
                                      f"demotions {demos}")
    for name, n in serve_launches.items():
        require(n > 0, f"serving path never launched {name}")
    side = []
    for mode in ("tpp", "static"):
        r = serve_compare(torch, np, ctx, mode, SIDE_STEPS, TOL["bf16"])
        c = r["state"]["kv"].counters
        side.append(f"{mode}: promotions {int(c.promotions.sum())} "
                    f"demotions {int(c.demotions.sum())}, step ms mean "
                    f"{sum(r['ms']) / len(r['ms']):.3f}")
        check_compare(np, r, TOL["bf16"], f"9-serve-{mode}-agree")
        del r
    phase("9-serve-modes", f"{SIDE_STEPS} steps each: " + " | ".join(side))

    # ---- 10. decode == forward at full width in float32 --------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tcfg_fw = TieringConfig(n_tenants=2, page_tokens=tcfg.page_tokens,
                            thrash_table_slots=256, lower_protection=(2, 2),
                            upper_bound=(3, 3))
    model32 = DenseLM(cfg32, seed=0, device="cuda")
    toks_fw = toks[:FWD_BATCH, :FWD_STEPS].contiguous()
    ctx32 = dict(ctx, cfg=cfg32, tcfg=tcfg_fw, model=model32, toks=toks_fw,
                 steps=FWD_STEPS)
    r32 = serve_compare(torch, np, ctx32, "equilibria", FWD_STEPS,
                        TOL["f32"])
    SD.equilibria_kv_step = kv_step
    with torch.no_grad():
        ref_logits = lm_forward(model32, toks_fw)
    dec = torch.stack(r32["logits"], dim=1)
    fw_rel = float((dec - ref_logits).abs().max() / ref_logits.abs().max())
    c = r32["state"]["kv"].counters
    fw_moves = int(c.promotions.sum() + c.demotions.sum())
    fw_slow = int((r32["state"]["kv"].slow_page >= 0).sum())
    require(fw_rel <= FWD_RTOL, f"decode != forward: {fw_rel:.3g}")
    require(fw_moves > 0 and fw_slow > 0, "decode/forward: no migrations")
    phase("10-serve-forward", f"f32 full width, {FWD_BATCH} seqs x "
          f"{FWD_STEPS} steps: max |decode - forward| / max |logit| = "
          f"{fw_rel:.3g} <= {FWD_RTOL} with {fw_moves} page moves and "
          f"{fw_slow} slow pages")
    check_compare(np, r32, TOL["f32"], "10-serve-f32-agree")
    del model32, r32, dec, ref_logits

    # ---- 11. serving kernels: time, bound, plain, library -----------------
    pt = tcfg.page_tokens
    H, D, Kh = cfg.num_heads, cfg.resolved_head_dim, cfg.num_kv_heads
    L = cfg.num_layers
    Mf, Ms = kv.fast_page.shape[1], kv.slow_page.shape[1]
    q = torch.randn((B, H, D), device="cuda").to(torch.bfloat16)
    pools0 = (kv.fast_k[0], kv.fast_v[0], kv.slow_k[0], kv.slow_v[0])
    n_valid = (valid_tokens(torch, kv.fast_page, kv.seq_len, pt)
               + valid_tokens(torch, kv.slow_page, kv.seq_len, pt))
    qs, ks, vs, mask = sdpa_inputs(torch, q, pools0,
                                   (kv.fast_page, kv.slow_page), kv.seq_len,
                                   pt)
    ks = ks.repeat_interleave(H // Kh, dim=1)
    vs = vs.repeat_interleave(H // Kh, dim=1)

    def k5(partial):
        return lambda: (partial(q, pools0[0], pools0[1], kv.fast_page,
                                kv.seq_len),
                        partial(q, pools0[2], pools0[3], kv.slow_page,
                                kv.seq_len))

    rng = np.random.default_rng(11)
    sel = torch.zeros(B, dtype=torch.bool, device="cuda")
    sel[torch.as_tensor(rng.permutation(B)[:16], device="cuda")] = True
    si = torch.as_tensor(rng.integers(0, Mf, B).astype(np.int32),
                         device="cuda")
    di = torch.as_tensor(rng.integers(0, Ms, B).astype(np.int32),
                         device="cuda")
    page_elems = pt * Kh * D
    sel_b = sel.nonzero()[:, 0]
    lay = torch.arange(L, device="cuda")[:, None]
    src_rows = ((lay * B + sel_b) * Mf + si[sel_b].long()).reshape(-1)
    dst_rows = ((lay * B + sel_b) * Ms + di[sel_b].long()).reshape(-1)
    gathered = kv.fast_k.view(-1, page_elems).index_select(0, src_rows)
    slow_flat = kv.slow_k.view(-1, page_elems)
    n_sel = int(sel.sum())
    elem = kv.fast_k.element_size()
    serve_bytes = {
        "pool_attention_partial": (
            n_valid * Kh * D * elem * 2 + B * H * D * elem
            + B * (Mf + Ms) * 4 + B * 4
            + 2 * (B * H * D * 4 + 2 * B * H * 4) + B * H * (Mf + Ms) * 4),
        "migrate_pages": n_sel * L * page_elems * elem * 2 + 3 * B * 4,
    }
    serve_ops = {"pool_attention_partial": n_valid * H * D * 4,
                 "migrate_pages": 0}
    serve_kern = {
        "pool_attention_partial": k5(TA.pool_attention_partial),
        "migrate_pages": lambda: KMIG.migrate_pages(kv.fast_k, kv.slow_k, si,
                                                    di, sel)}
    serve_plain = {
        "pool_attention_partial": k5(TA_REF.pool_attention_partial_ref),
        "migrate_pages": lambda: RMIG.migrate_pages_ref(kv.fast_k, kv.slow_k,
                                                        si, di, sel)}
    serve_lib = {
        "pool_attention_partial": lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask),
        "migrate_pages": lambda: slow_flat.index_copy_(0, dst_rows, gathered)}
    for name in SERVE_REPLACES:
        k_ms = device_ms(serve_kern[name])
        p_ms = device_ms(serve_plain[name])
        lib_ms = device_ms(serve_lib[name])
        t_bytes = serve_bytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = serve_ops[name] / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SERVE_SOURCE,
            "replaces": SERVE_REPLACES[name],
            "launches": serve_launches[name],
            "max_abs_err": serve_err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "launches_per_step": serve_launches[name] / steps,
            "bytes": serve_bytes[name],
            "bound_copy_ms": serve_bytes[name] / bw * 1e3,
        })
        what = ("one layer, both pools (2 launches), "
                f"{n_valid} valid tokens" if name == "pool_attention_partial"
                else f"{n_sel} of {B} sequences x {L} layers")
        phase("11-serve-kernel", f"{name} [{what}]: {k_ms:.4f} ms (plain "
              f"{p_ms:.4f}, library {lib_ms:.4f}, bound "
              f"{rows[-1]['bound_ms']:.5f} at 3.35 TB/s, "
              f"{rows[-1]['bound_copy_ms']:.5f} at measured copy "
              f"{bw / 1e12:.3f} TB/s) launches/step "
              f"{serve_launches[name] / steps:g}")
    del gathered, ks, vs, qs, mask

    # ---- 12. where one decode step's device time goes ---------------------
    snap = run["snapshot"]
    step_c = SD.build_serve_step(cfg, tcfg, B, steps, impl="cuda")
    tok = toks[:, steps // 2:steps // 2 + 1]
    walls = []
    with torch.no_grad():
        for _ in range(3):
            s0 = {"kv": clone_tree(torch, snap["kv"])}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_c(model, s0, tok)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        s0 = {"kv": clone_tree(torch, snap["kv"])}
        torch.cuda.synchronize()
        prof = step_profile(torch, step_c, model, s0, tok)
    wall_ms = sorted(walls)[1]
    if prof is None:
        phase("12-serve-profile", "device time not measured: the profiler "
                                  "saw no device event")
    else:
        n_dev, busy_ms, top = prof
        ours = {k: [(t, c) for nm, t, c in top if f"{k}_kernel" in nm]
                for k in SERVE_REPLACES}
        phase("12-serve-profile", f"one decode step at position {steps // 2}"
              f": {n_dev:g} device events, busy {busy_ms:.4f} ms of "
              f"{wall_ms:.4f} ms wall (idle share "
              f"{1 - busy_ms / wall_ms:.3f}); serving kernels ms/step: "
              + ", ".join(f"{k} {sum(t for t, _ in v):.4f} "
                          f"x{sum(c for _, c in v):g}"
                          for k, v in ours.items())
              + "; top by device ms: " + "; ".join(
                  f"{nm[:60]} {t:.4f} ms x{c:g}" for nm, t, c in top[:12]))
    phase("done", f"{time.perf_counter() - t_start:.1f}s on {smi_line}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
