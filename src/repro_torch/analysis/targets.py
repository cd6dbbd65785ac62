"""The real audit targets: what ``python -m repro_torch.analysis`` proves
things about (torch port of ``repro/analysis/targets.py``; the target
names are the reference's).

Each target is a call plus the metadata the passes need:

  tick:{static,dynamic}:{mode}  — the unified tick, every policy mode x
      both ownership providers, at the reference's small shapes, with
      ``impl="ref"``: the kernel-backed strategy over the kernels' plain
      versions (the *structure* is what is audited).
  tick:hotness:*                — the four hotness-provider ticks.
  tick:scale                    — the dynamic tick at the ROADMAP's fleet
      scale point (L=262,144 pages, T=64, S=4,096, horizon 10k): where
      the overflow pass has to prove which int32 counters survive and
      which do not (the baseline acknowledges the unsafe ones; the fix is
      the int64 ``CounterLedger`` in obs/fleet.py). One tick there is a
      second or two on the CPU.
  fleet:chunk                   — the chunked rollout program
      (``obs.fleet.make_fleet_chunk``) with both seams, and the donation
      contract of its state: bytes not growing tick over tick.
  kernel:*                      — the eight kernel wrappers at the
      reference's tiny shapes (all eight kernels accept them): their
      plain versions on the CPU, their kernels on the card, where a
      wrapper that does not launch is a finding.
  tick:cuda:equilibria          — the counterpart of the reference's
      ``tick:pallas:equilibria``: the static tick with ``impl="cuda"``
      (K1-K4), only with ``device="cuda"``.

Interval shadows cannot see inside a ctypes kernel, so the overflow pass
runs on the ``ref`` targets (the card's integer state equals ``ref``'s
bit for bit: ``chip_smoke.py`` holds cuda == ref every tick); the
``cuda`` targets run purity, dtype, constancy and donation. The tick's
periodic controller is a host-side ``if`` on the host tick counter, so
every tick target also runs in the tick where the controller fires.

Constancy sweeps (the tick's op trace invariant in T, L and the hotness
provider's branch) are exposed as builders for the CLI and the test suite;
on the card ``c1_tick_target`` adds the cuda tick at C1's size (T = 32 and
64 over L = 262,144), audited for purity and constancy in both controller
phases and captured in a CUDA graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.interval import BOOL, Interval

# declared input ranges for the overflow pass (trace data bounds)
RATE_MAX = 1.0e4          # per-page access rate per tick
DEFAULT_HORIZON = 10_000  # the ROADMAP fleet horizon
SCALE = dict(T=64, L=262_144, S=4096, k_max=256, horizon=DEFAULT_HORIZON)
# C1 (``bench_tick``): T tenants over L pages, fast tier L/4
C1 = dict(L=262_144, k_max=256, T=(32, 64))


@dataclass
class AuditTarget:
    """One call plus the metadata the passes consume."""
    name: str
    fn: Callable
    # argument tuples, one per host-side branch (the first is the main one)
    phases: List[tuple]
    names: Tuple[str, ...] = ("state", "inputs")
    # (argument index, result index) of the carried state, or None
    carry: Optional[Tuple[int, int]] = (0, 0)
    # declared ranges of input leaves by name; None: no overflow pass
    input_ivals: Optional[Dict[str, Interval]] = None
    horizon: int = DEFAULT_HORIZON
    # the donation contract: called with the report, returns its readings
    donation: Optional[Callable] = None
    # the kernel wrapper this target must launch on the card
    kernel: Optional[str] = None


def _controller_phases(state, inputs, period: int) -> List[tuple]:
    """The tick at t = 0 and, when it differs, at the tick in which the
    periodic controller runs (t + 1 a multiple of the period)."""
    phases = [(state, inputs)]
    if period > 1:
        phases.append((state._replace(t=period - 1), inputs))
    return phases


def _small_cfg(T: int = 3, fast: int = 48, slow: int = 48, **kw):
    from repro_torch.configs.base import TieringConfig
    return TieringConfig(n_tenants=T, n_fast_pages=fast, n_slow_pages=slow,
                         lower_protection=tuple([fast // (2 * T)] * T),
                         upper_bound=tuple([fast] * T), **kw)


def static_tick_target(mode: str, T: int = 3, pages_per: int = 16,
                       k_max: int = 8, horizon: int = DEFAULT_HORIZON,
                       hotness=None, impl: str = "ref", device="cuda",
                       name: Optional[str] = None) -> AuditTarget:
    from repro_torch.core.engine import make_tick
    from repro_torch.core.state import init_state
    cfg = _small_cfg(T=T, fast=T * pages_per // 2, slow=T * pages_per)
    owner = np.repeat(np.arange(T), pages_per)
    L = owner.shape[0]
    tick = make_tick(cfg, owner, mode=mode, k_max=k_max, hotness=hotness,
                     impl=impl, device=device)
    state = init_state(cfg, L, owner=owner, hotness=hotness, device=device)
    dev = state.tier.device
    inputs = (torch.zeros((L,), dtype=torch.float32, device=dev),
              torch.ones((L,), dtype=torch.bool, device=dev))
    ivals = {"inputs[0]": Interval(0, RATE_MAX, False),   # accesses [L]
             "inputs[1]": BOOL}                           # alive [L]
    return AuditTarget(
        name=name or f"tick:static:{mode}", fn=tick,
        phases=_controller_phases(state, inputs, cfg.controller_period),
        input_ivals=None if impl == "cuda" else ivals, horizon=horizon)


def hotness_tick_targets(device="cuda") -> List[AuditTarget]:
    """Provider tick programs under the purity/dtype/overflow passes.

    The sketch provider picks its probe branch when the tick is built
    (full enumeration when the per-tenant budget covers the rowspace,
    sampled draws otherwise) — both are distinct audit targets."""
    from repro_torch.core.hotness import SketchSpec
    variants = [
        ("sampled", "tick:hotness:sampled"),
        ("sketch", "tick:hotness:sketch"),          # full-coverage branch
        (SketchSpec(probe=6), "tick:hotness:sketch-sampled"),
        ("neomem", "tick:hotness:neomem"),
    ]
    return [static_tick_target("equilibria", hotness=spec, name=name,
                               device=device) for spec, name in variants]


def dynamic_tick_target(mode: str, T: int = 3, L: int = 64, S: int = 16,
                        k_max: int = 8, horizon: int = DEFAULT_HORIZON,
                        impl: str = "ref", device="cuda",
                        name: Optional[str] = None) -> AuditTarget:
    from repro_torch.core.churn import make_churn_tick
    from repro_torch.core.state import init_state
    cfg = _small_cfg(T=T, fast=L // 2, slow=L // 2)
    tick = make_churn_tick(cfg, L, mode=mode, k_max=k_max, impl=impl,
                           device=device)
    state = init_state(cfg, L, device=device)
    dev = state.tier.device
    inputs = (torch.zeros((T, S), dtype=torch.float32, device=dev),
              torch.zeros((T,), dtype=torch.int32, device=dev))
    ivals = {"inputs[0]": Interval(0, RATE_MAX, False),   # rates [T, S]
             "inputs[1]": Interval(0, float(S), True)}    # want [T]
    return AuditTarget(
        name=name or f"tick:dynamic:{mode}", fn=tick,
        phases=_controller_phases(state, inputs, cfg.controller_period),
        input_ivals=None if impl == "cuda" else ivals, horizon=horizon)


def scale_tick_target(device="cuda") -> AuditTarget:
    """The ROADMAP scale point: where int32 counters provably wrap. The
    shadow runs the real L=262,144 / T=64 tick, not a toy stand-in."""
    return dynamic_tick_target(
        "equilibria", T=SCALE["T"], L=SCALE["L"], S=SCALE["S"],
        k_max=SCALE["k_max"], horizon=SCALE["horizon"], device=device,
        name="tick:scale")


def cuda_tick_target(device="cuda") -> AuditTarget:
    """The kernel-backed tick (K1-K4 through their ctypes launchers)."""
    return static_tick_target("equilibria", impl="cuda", device=device,
                              name="tick:cuda:equilibria")


def fleet_chunk_target(chunk: int = 5, T: int = 4, L: int = 64,
                       S: int = 16, H: int = 2, k_max: int = 8,
                       device="cuda") -> AuditTarget:
    """The chunked rollout program over H hosts with the streaming
    detectors and the attribution ledger. ``chunk`` = the controller
    period, so the chunk holds a tick in which the controller runs. Its
    casts are audited at the chunk length; its donation contract is the
    state's bytes (and on the card ``memory_allocated``) never above
    their values after the second of six one-tick chunks (the fifth runs
    the controller)."""
    from repro_torch.core.churn import make_churn_tick
    from repro_torch.core.state import init_state
    from repro_torch.obs.attribution import make_attribution
    from repro_torch.obs.fleet import make_fleet_chunk
    from repro_torch.obs.streaming import make_detector
    from repro_torch.analysis.op_audit import steady_memory_pass
    cfg = _small_cfg(T=T, fast=L // 2, slow=L // 2)
    det = make_detector(chunk, T, cfg.lower_protection)
    att = make_attribution(T, cfg.lat_fast)
    tick = make_churn_tick(cfg, L, mode="equilibria", k_max=k_max,
                           detector=det, attrib=att, impl="ref",
                           device=device)
    period = 8

    def fresh():
        return [init_state(cfg, L, detector=det, attrib=att, device=device)
                for _ in range(H)]

    states = fresh()
    dev = states[0].tier.device
    want = torch.full((H, period, T), S // 2, dtype=torch.int32, device=dev)
    rates = torch.ones((H, period, T, S), dtype=torch.float32, device=dev)
    arch = list(range(H))
    chunk_fn = make_fleet_chunk(tick, want, rates, period, chunk)
    one_tick = make_fleet_chunk(tick, want, rates, period, 1)

    def fn(states_, arch_, t0):
        # the chunk advances the hosts in place in its list: a copy keeps
        # the target's arguments at tick 0
        return chunk_fn(list(states_), arch_, t0)

    def donation(report):
        clock = iter(range(1 << 30))
        return steady_memory_pass(
            lambda s: one_tick(s, arch, next(clock))[0], fresh(), 6,
            "fleet:chunk", report)

    return AuditTarget(
        name="fleet:chunk", fn=fn, phases=[(states, arch, 0)],
        names=("states", "arch", "t0"), carry=(0, 0), input_ivals={},
        horizon=chunk, donation=donation)


def kernel_targets(device="cuda") -> List[AuditTarget]:
    """The eight kernel wrappers at the reference's audit shapes."""
    from repro_torch.analysis.op_audit import donation_pass
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.migrate.ops import commit_moves, migrate_pages
    from repro_torch.kernels.select.ops import seg_reduce, seg_sums, seg_topk
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.tiered_attention.ops import tiered_attention
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    out: List[AuditTarget] = []

    def add(name, fn, args, names, kernel, donation=None):
        out.append(AuditTarget(name=name, fn=fn, phases=[args], names=names,
                               carry=None, kernel=kernel,
                               donation=donation))

    B, Hh, Ss, D = 1, 2, 32, 16
    # float32: K7's tf32x3 route (every f32 launch takes it;
    # ``flash_attention.routes`` counts it)
    q = torch.ones((B, Hh, Ss, D), **f32)
    add("kernel:flash_attention",
        lambda q, k, v: flash_attention(q, k, v), (q, q, q),
        ("q", "k", "v"), "flash_attention")

    # pools: [L, B, Mp, pt, K, D]
    Lk, Bk, Mp, pt, Kk = 2, 2, 4, 4, 2
    src = torch.ones((Lk, Bk, Mp, pt, Kk, D), **f32)
    dst = torch.zeros((Lk, Bk, Mp, pt, Kk, D), **f32)
    idx = torch.zeros((Bk,), **i32)
    sel = torch.ones((Bk,), **b8)
    mig_args = (src, dst, idx, idx, sel)
    add("kernel:migrate", migrate_pages, mig_args,
        ("src", "dst", "src_idx", "dst_idx", "sel"), "migrate_pages",
        donation=lambda report: donation_pass(
            migrate_pages, mig_args, (1,), "kernel:migrate", report))

    x = torch.ones((B, 64, 2, 8), **f32)        # [B,S,H,P]
    a = torch.ones((B, 64, 2), **f32)
    bc = torch.ones((B, 64, 2, 4), **f32)       # [B,S,G,N]
    add("kernel:ssd_scan",
        lambda x, a, b, c: ssd_scan(x, a, b, c, chunk=32), (x, a, bc, bc),
        ("x", "a", "b", "c"), "ssd_scan")

    Mf, Ms, pt2, K = 4, 4, 8, 2
    q1 = torch.ones((B, 1, Hh, D), **f32)
    fk = torch.ones((B, Mf, pt2, K, D), **f32)
    sk = torch.ones((B, Ms, pt2, K, D), **f32)
    fp = torch.zeros((B, Mf), **i32)
    sp = torch.full((B, Ms), -1, **i32)
    sl = torch.full((B,), pt2, **i32)
    add("kernel:tiered_attention", tiered_attention,
        (q1, fk, fk, sk, sk, fp, sp, sl),
        ("q", "fast_k", "fast_v", "slow_k", "slow_v", "fast_page",
         "slow_page", "seq_len"), "pool_attention_partial")

    # selection-core kernels (kernels/select + the fused page-move commit)
    Ts, Sw = 3, 16
    score = torch.ones((Ts, Sw), **f32)
    valid = torch.ones((Ts, Sw), **b8)
    quotas = torch.ones((Ts,), **i32)
    add("kernel:seg_topk", lambda s, v, q: seg_topk(s, v, q, 4),
        (score, valid, quotas), ("score", "valid", "quotas"), "seg_topk")
    xi = torch.ones((Ts, Sw), **i32)
    add("kernel:seg_reduce", seg_reduce, (xi, valid), ("x", "valid"),
        "seg_reduce")
    add("kernel:seg_sums", seg_sums, (xi, valid), ("x", "valid"),
        "seg_sums")
    Lc, Cc, Nc = 24, 8, 6
    add("kernel:commit_moves",
        lambda *a: commit_moves(*a, 0, direction=1, to_tier=0),
        (torch.zeros((Lc,), **i32), torch.zeros((Cc, 5), **i32),
         torch.zeros((), **i32), torch.zeros((Nc,), **i32),
         torch.zeros((Nc,), **b8), torch.zeros((Nc,), **i32),
         torch.zeros((Nc,), **f32)),
        ("tier", "ring", "head", "pages", "take", "tenants", "hot"),
        "commit_moves")
    return out


# ------------------------------------------------------ constancy sweeps ----
def _call(target: AuditTarget):
    return target.fn, target.phases[0]


def tick_constancy_sweeps(device="cuda"
                          ) -> Dict[str, Tuple[Callable, Sequence]]:
    """name -> (build, params): calls whose op trace must be constant.

    Each build(p) returns (fn, args); the constancy checker asserts op
    count + op histogram (+ kernel launches) are identical across the
    sweep. ``tick:cuda:T`` is the counterpart of the reference's
    ``tick:pallas:T``: the kernel-backed strategy, on its kernels on the
    card and on their plain versions on the CPU."""
    kernel_impl = "cuda" if torch.device(device).type == "cuda" else "ref"
    sweeps = {
        "tick:static:T": (lambda T: _call(static_tick_target(
            "equilibria", T=T, device=device)), (2, 4)),
        "tick:dynamic:T": (lambda T: _call(dynamic_tick_target(
            "equilibria", T=T, device=device)), (2, 4)),
        "tick:dynamic:L": (lambda L: _call(dynamic_tick_target(
            "equilibria", L=L, device=device)), (64, 128)),
        "tick:cuda:T": (lambda T: _call(static_tick_target(
            "equilibria", T=T, impl=kernel_impl, device=device)), (2, 4)),
    }
    sweeps.update(hotness_constancy_sweeps(device))
    return sweeps


def hotness_constancy_sweeps(device="cuda"
                             ) -> Dict[str, Tuple[Callable, Sequence]]:
    """Provider ticks must not unroll in T, and the sketch/neomem candidate
    paths must not grow op structure with L. The sketch L-sweeps hold the
    build-time probe branch fixed: ``probe=6`` keeps both L values in the
    sampled regime, the default spec keeps both in full coverage."""
    from repro_torch.core.hotness import SketchSpec

    def build_T(prov):
        return lambda T: _call(static_tick_target(
            "equilibria", T=T, hotness=prov, device=device))

    def build_L(prov):
        return lambda pages_per: _call(static_tick_target(
            "equilibria", pages_per=pages_per, hotness=prov, device=device))

    sampled_regime = SketchSpec(probe=6)
    return {
        "tick:hotness:sampled:T": (build_T("sampled"), (2, 4)),
        "tick:hotness:sketch:T": (build_T(sampled_regime), (2, 4)),
        "tick:hotness:neomem:T": (build_T("neomem"), (2, 4)),
        "tick:hotness:sketch:L": (build_L(sampled_regime), (16, 32)),
        "tick:hotness:sketch-full:L": (build_L("sketch"), (16, 32)),
        "tick:hotness:neomem:L": (build_L("neomem"), (16, 32)),
    }


def c1_tick_target(T: int, device="cuda") -> AuditTarget:
    """The cuda static tick at C1's size (card only): ``bench_tick``'s
    config and inputs (30% of pages hot) at T tenants over L = 262,144
    pages, in the tick without and the tick with the controller. The
    audit runs purity and constancy over it at T = 32 and 64, and the
    capture probe captures it at T = 64, one graph per controller phase."""
    from repro_torch.configs.base import TieringConfig
    from repro_torch.core.engine import make_tick
    from repro_torch.core.state import init_state
    L = C1["L"]
    share = L // (4 * T)
    cfg = TieringConfig(n_tenants=T, n_fast_pages=L // 4, n_slow_pages=L,
                        lower_protection=(max(share // 2, 1),) * T,
                        upper_bound=(2 * share,) * T)
    owner = np.repeat(np.arange(T, dtype=np.int32), L // T)
    tick = make_tick(cfg, owner, mode="equilibria", k_max=C1["k_max"],
                     impl="cuda", device=device)
    state = init_state(cfg, L, owner=owner, device=device)
    rng = np.random.default_rng(0)
    acc = np.where(rng.random(L) < 0.3, 4.0, 0.1).astype(np.float32)
    dev = state.tier.device
    inputs = (torch.as_tensor(acc, device=dev),
              torch.ones((L,), dtype=torch.bool, device=dev))
    return AuditTarget(
        name=f"tick:cuda:C1:T={T}", fn=tick,
        phases=_controller_phases(state, inputs, cfg.controller_period))


# ------------------------------------------------------------- registry ----
def all_targets(device="cuda", scale: bool = True,
                fleet: bool = True) -> List[AuditTarget]:
    from repro_torch.core.tick import MODES
    out: List[AuditTarget] = []
    for mode in MODES:
        out.append(static_tick_target(mode, device=device))
    for mode in MODES:
        out.append(dynamic_tick_target(mode, device=device))
    out.extend(hotness_tick_targets(device))
    if torch.device(device).type == "cuda":
        out.append(cuda_tick_target(device))
    if scale:
        out.append(scale_tick_target(device))
    if fleet:
        out.append(fleet_chunk_target(device=device))
    out.extend(kernel_targets(device))
    return out
