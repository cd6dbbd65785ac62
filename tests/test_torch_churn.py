"""Dynamic ownership (tenant churn) and non-contiguous static owners of the
port held against the JAX reference on seeded inputs (CPU, small sizes).

Pairs: the port's ``impl="batched"`` against the reference's ``"batched"``
(composite sort), the port's ``"ref"`` (the segmented top-k's plain version
over a run-time rowspace) against the reference's ``"pallas_ref"``. Integer
outputs and states are compared bitwise every tick; latency and throughput
within rtol 1e-5 / 1e-4 and atol 1e-4, the reference's own bound for float
sums whose association differs (``tests/test_tick_unification.py``): the
port adds the f32 perf-model sums in float64 and rounds once.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from proputil import seeded_property

from repro.configs.base import TieringConfig as JCfg
from repro.core import churn as JCH
from repro.core import engine as JENG
from repro.core import policy as JP
from repro.core import select as JSEL
from repro.core import simulator as JSIM
from repro.core import workloads as JW
from repro.core.state import TenantPolicy as JPol
from repro.core.state import init_state as j_init_state
from repro_torch import convert
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.core import churn as TCH
from repro_torch.core import engine as TENG
from repro_torch.core import policy as TP
from repro_torch.core import select as TSEL
from repro_torch.core import simulator as TSIM
from repro_torch.core import workloads as TW
from repro_torch.core.state import TenantPolicy as TPol
from repro_torch.core.state import init_state as t_init_state
from repro_torch.obs import stats as TOS
from test_golden_trace import GOLDEN_DIR, _collect, _diff

IMPLS = [("batched", "batched"), ("ref", "pallas_ref")]
MODES = ("equilibria", "tpp", "memtis", "static")
FLOAT_TOL = {"latency": dict(rtol=1e-5, atol=1e-4),
             "throughput": dict(rtol=1e-4, atol=1e-4)}


def T_(x):
    return torch.as_tensor(np.array(x))


def eq(port, ref, msg=""):
    p = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_array_equal(p, np.asarray(ref), err_msg=msg)


def assert_outputs_match(got, want):
    """Per-tick outputs: ints and promo_scale bitwise, the perf model within
    the association tolerance."""
    for f in want._fields:
        x, y = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f in FLOAT_TOL:
            np.testing.assert_allclose(x, y, err_msg=f, **FLOAT_TOL[f])
        else:
            eq(x, y, f)


def assert_states_match(got, want):
    """Every state leaf bitwise (hot and the windowed rates round as the
    reference's fused multiply-adds do)."""
    for f, v in convert.state_to_numpy(got).items():
        ref = getattr(want, f)
        if isinstance(v, dict):
            for g, w in v.items():
                eq(w, getattr(ref, g), f"{f}.{g}")
        elif v is None:
            assert ref is None, f
        else:
            eq(v, ref, f)


# ------------------------------------------------------------ scenarios ----
# Each scenario builds (cfg, schedule, pool size or None) from one side's
# modules: (workloads, TieringConfig, churn).
def _churn_small(W, Cfg, CH):
    """The reference's ``churn_small`` golden roster."""
    slots = [W.ChurnSlot(W.web_like(40), [(0, 80)]),
             W.ChurnSlot(W.microbenchmark(32, ramp=3), [(4, 30), (40, 70)]),
             *W.serverless_bursts(2, 80, footprint=24, seed=3)]
    cfg = Cfg(n_tenants=4, n_fast_pages=64, n_slow_pages=120,
              lower_protection=(16, 8, 0, 0), upper_bound=(0, 24, 0, 0))
    return cfg, W.build_churn_schedule(slots, 80), None


def _oversubscribed(W, Cfg, CH):
    """A roster that asks for more pages than the pool holds, with slots
    leaving and coming back."""
    rng = np.random.default_rng(11)
    ticks, T, S = 40, 4, 40
    want = np.zeros((ticks, T), np.int32)
    for i in range(T):
        on = sorted(rng.integers(0, ticks, 4))
        want[on[0]:on[1], i] = rng.integers(20, S + 1)
        want[on[2]:on[3], i] = rng.integers(8, S + 1)
    rates = (rng.random((ticks, T, S)) * 6).astype(np.float32)
    rates[rng.random(rates.shape) < 0.4] = 0.0
    cfg = Cfg(n_tenants=T, n_fast_pages=24, n_slow_pages=40,
              lower_protection=(10, 6, 0, 4), upper_bound=(0, 16, 12, 0))
    return cfg, CH.ChurnSchedule(want, rates), 56


def _weighted(W, Cfg, CH):
    """Weighted fair shares under an oversubscribed protection budget."""
    slots = W.churn_stacked(3, 3, 2, ticks=60, seed=4)
    prot, bound = W.suggest_churn_policy(slots)
    cfg = Cfg(n_tenants=len(slots), n_fast_pages=192, n_slow_pages=512,
              lower_protection=tuple(p + 20 for p in prot),
              upper_bound=bound,
              tenant_weights=(1.0, 2.5, 0.5, 1.5, 3.0, 0.75, 1.0, 2.0))
    return cfg, W.build_churn_schedule(slots, 60), None


SCENARIOS = {"churn_small": _churn_small, "oversubscribed": _oversubscribed,
             "weighted": _weighted}


def _schedule(name, side):
    mods = (TW, TCfg, TCH) if side == "port" else (JW, JCfg, JCH)
    return SCENARIOS[name](*mods)


@functools.lru_cache(maxsize=None)
def _reference_churn(name, impl, mode="equilibria", k_max=32, hotness=None):
    cfg, sched, L = _schedule(name, "ref")
    final, outs = JCH.run_churn_engine(cfg, sched, mode=mode, k_max=k_max,
                                       n_pages=L, impl=impl, hotness=hotness)
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return host(final), host(outs)


@pytest.mark.parametrize("impl_t,impl_j", IMPLS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_churn_engine_matches_reference(name, impl_t, impl_j):
    cfg, sched, L = _schedule(name, "port")
    final, outs = TCH.run_churn_engine(cfg, sched, k_max=32, n_pages=L,
                                       impl=impl_t, device="cpu")
    want_final, want_outs = _reference_churn(name, impl_j)
    assert_outputs_match(outs, want_outs)
    assert_states_match(final, want_final)
    assert outs.promotions.sum() > 0 and outs.demotions.sum() > 0


def test_oversubscribed_scenario_is_oversubscribed():
    cfg, sched, L = _schedule("oversubscribed", "port")
    assert (sched.want.sum(1) > L).any()
    a, d = TCH.churn_events(sched.want)
    assert a >= 6 and d >= 4


@pytest.mark.parametrize("impl", ["batched", "ref"])
@pytest.mark.parametrize("name", ["churn_small", "churn16_sketch"])
def test_churn_golden(name, impl):
    """The reference's churn goldens through the port's ``simulate_churn``:
    ints exact, floats within atol 1e-4 (the fixtures' own rule)."""
    if name == "churn_small":
        cfg, sched, _ = _schedule("churn_small", "port")
        slots = [TW.ChurnSlot(TW.web_like(40), [(0, 80)]),
                 TW.ChurnSlot(TW.microbenchmark(32, ramp=3),
                              [(4, 30), (40, 70)]),
                 *TW.serverless_bursts(2, 80, footprint=24, seed=3)]
        r = TSIM.simulate_churn(cfg, slots, 80, k_max=32, impl=impl,
                                device="cpu")
    else:
        cfg, slots = TSIM.CHURN_PRESETS["churn16"]()
        r = TSIM.simulate_churn(cfg.with_(n_tenants=len(slots)), slots, 100,
                                k_max=64, hotness="sketch", impl=impl,
                                device="cpu")
    got = _collect(r)
    want = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    assert sorted(want) == sorted(got), "telemetry key set drifted"
    for key in sorted(want):
        _diff(got[key], want[key], key)


# ----------------------------------------------------------- components ----
@pytest.mark.parametrize("seed", range(6))
def test_pool_grant_matches_reference(seed):
    rng = np.random.default_rng(seed)
    L, T = int(rng.choice([1, 37, 500])), int(rng.choice([1, 3, 16]))
    free = rng.random(L) < rng.choice([0.0, 0.3, 1.0])
    need = rng.integers(0, max(L // T, 1) + 3, T).astype(np.int32)
    need[rng.random(T) < 0.3] = 0
    got = TSEL.pool_grant(T_(free), T_(need))
    want = jax.jit(JSEL.pool_grant)(jnp.asarray(free), jnp.asarray(need))
    eq(got, want)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", range(5))
def test_repartition_policy_matches_reference(seed, weighted):
    """Integer asks are exact in float32; fractional weights make the f32
    ``ask.sum()`` association matter (it feeds a floor), and the port's sum
    agrees with the jitted reference's bitwise at T up to 64."""
    rng = np.random.default_rng(seed)
    T = int(rng.choice([3, 16, 64]))
    prot = np.where(rng.random(T) < 0.7, rng.integers(1, 5000, T), 0
                    ).astype(np.int32)
    bound = rng.integers(0, 9000, T).astype(np.int32)
    active = rng.random(T) < 0.7
    cap = int(rng.integers(100, 60000))
    w = (rng.random(T) * 4 + 0.1).astype(np.float32) if weighted else None
    got = TP.repartition_policy(TPol(T_(prot), T_(bound)), T_(active), cap,
                                None if w is None else T_(w))
    want = jax.jit(lambda p, b, a, ww: JP.repartition_policy(
        JPol(p, b), a, cap, ww))(jnp.asarray(prot), jnp.asarray(bound),
                                 jnp.asarray(active),
                                 None if w is None else jnp.asarray(w))
    eq(got.lower_protection, want.lower_protection, "protection")
    eq(got.upper_bound, want.upper_bound, "bound")


def test_repartition_policy_cases():
    """The reference's worked cases (tests/test_churn.py)."""
    base = TPol(torch.tensor([100, 100, 50], dtype=torch.int32),
                torch.tensor([0, 120, 60], dtype=torch.int32))

    def prot(active, cap, weights=None):
        pol = TP.repartition_policy(base, torch.tensor(active), cap,
                                    None if weights is None
                                    else torch.tensor(weights))
        return pol.lower_protection.tolist(), pol.upper_bound.tolist()

    assert prot([True, True, True], 400) == ([100, 100, 50], [0, 120, 60])
    assert prot([True, False, True], 400) == ([100, 0, 50], [0, 0, 60])
    assert prot([True, False, True], 100)[0] == [66, 0, 33]
    assert prot([True, False, True], 100, [1.0, 1.0, 3.0])[0] == [40, 0, 50]


def test_slot_reuse_resets_controller_state():
    """A fresh arrival in a previously used slot starts with clean
    controller state; the other slot keeps its own (reference
    tests/test_churn.py), bitwise with the reference's tick."""
    cfg_t = TCfg(n_tenants=2, n_fast_pages=16, n_slow_pages=16)
    cfg_j = JCfg(n_tenants=2, n_fast_pages=16, n_slow_pages=16)
    carry = dict(promo_scale=np.array([0.25, 0.5], np.float32),
                 steady=np.array([True, True]),
                 mitigated_prev=np.array([True, True]),
                 thrash_prev=np.array([3, 4], np.int32),
                 usage_prev=np.array([5, 6], np.int32),
                 freed_since=np.array([7, 8], np.int32))
    rates = np.ones((2, 8), np.float32)
    want = np.array([8, 0], np.int32)
    jt = JCH.make_churn_tick(cfg_j, 32)
    js = j_init_state(cfg_j, 32)._replace(
        **{k: jnp.asarray(v) for k, v in carry.items()})
    j_new, j_out = jax.jit(jt)(js, (jnp.asarray(rates), jnp.asarray(want)))
    for impl in ("batched", "ref"):
        tt = TCH.make_churn_tick(cfg_t, 32, impl=impl, device="cpu")
        ts = t_init_state(cfg_t, 32, device="cpu")._replace(
            **{k: T_(v) for k, v in carry.items()})
        t_new, t_out = tt(ts, (T_(rates), T_(want)))
        assert float(t_new.promo_scale[0]) == 1.0    # arrived: reset
        assert float(t_new.promo_scale[1]) == 0.5    # untouched
        assert not bool(t_new.steady[0]) and not bool(t_new.mitigated_prev[0])
        assert int(t_new.usage_prev[0]) == 0
        assert_states_match(t_new, jax.tree_util.tree_map(np.asarray, j_new))
        assert_outputs_match(t_out, jax.tree_util.tree_map(np.asarray, j_out))


def test_record_fast_exits_empty_mask_is_a_no_op():
    """The dynamic tick records reclaimed fast pages' exits every tick (the
    reference skips the call when no reclaimed page was fast): an empty
    mask must leave every TierStats leaf bitwise unchanged."""
    rng = np.random.default_rng(5)
    L, T = 300, 4
    stats = TOS.init_stats(T, (L,), device="cpu")
    stats = stats._replace(
        fast_since=T_(np.where(rng.random(L) < 0.5,
                               rng.integers(0, 40, L), -1).astype(np.int32)),
        resid_hist=T_(rng.integers(0, 9, tuple(stats.resid_hist.shape)
                                   ).astype(np.int32)))
    owners = T_(rng.integers(0, T, L).astype(np.int32))
    out = TOS.record_fast_exits(stats, torch.zeros(L, dtype=torch.bool),
                                owners, 57)
    for f in stats._fields:
        a, b = getattr(stats, f), getattr(out, f)
        assert torch.equal(a, b) and a.dtype == b.dtype, f


@pytest.mark.parametrize("impl_t,impl_j", IMPLS)
@pytest.mark.parametrize("seed", range(5))
def test_dynamic_strategies_match_reference(seed, impl_t, impl_j):
    """select / by_tenant / alloc_ranks over a run-time owner vector with
    free-pool sentinels (owner == T)."""
    rng = np.random.default_rng(seed)
    T = int(rng.choice([1, 3, 7]))
    L = int(rng.choice([40, 123, 300]))
    owner = rng.integers(0, T + 1, L).astype(np.int32)     # T = free
    k_max = int(rng.choice([3, 16, 64]))
    score = (rng.integers(-3, 3, L) if seed % 2
             else rng.standard_normal(L)).astype(np.float32)
    score[rng.random(L) < 0.05] = -np.inf
    active = (rng.random(L) < rng.choice([0.3, 0.8, 1.0])) & (owner < T)
    quotas = rng.integers(-1, L // T + 4, T).astype(np.int32)
    js = JSEL.dynamic_strategy(T, k_max, impl=impl_j)
    ts = TSEL.dynamic_strategy(T, k_max, impl=impl_t, device="cpu")
    jo = jnp.asarray(owner)
    a = ts.select(T_(score), T_(owner), T_(active), T_(quotas))
    b = jax.jit(js.select)(jnp.asarray(score), jo, jnp.asarray(active),
                           jnp.asarray(quotas))
    eq(a.mask, b.mask, "mask")
    assert a.pages is None and b.pages is None
    xi = rng.integers(-5, 5, L).astype(np.int32)
    eq(ts.by_tenant(T_(xi), T_(owner)),
       jax.jit(js.by_tenant)(jnp.asarray(xi), jo), "by_tenant int")
    xf = (rng.random(L) * 4).astype(np.float32)
    np.testing.assert_allclose(
        ts.by_tenant(T_(xf), T_(owner)).numpy(),
        np.asarray(jax.jit(js.by_tenant)(jnp.asarray(xf), jo)),
        rtol=1e-6, atol=1e-5)      # f32 scatter association differs
    new = (rng.random(L) < 0.4) & (owner < T)
    ra = ts.alloc_ranks(T_(new), T_(owner)).numpy()
    rb = np.asarray(jax.jit(js.alloc_ranks)(jnp.asarray(new), jo))
    eq(ra[new], rb[new], "alloc ranks")


@pytest.mark.parametrize("cap", ["none", "below", "equal", "above_L"])
@pytest.mark.parametrize("seed", range(3))
def test_dynamic_strategy_s_max_matches_reference(seed, cap):
    """The rowspace cap: the port's kernel-backed dynamic strategy with
    ``s_max`` against the reference's ``pallas_dynamic_strategy`` (its
    plain version) with the same ``s_max``, selection masks bitwise. Below
    the largest tenant's footprint, pages ranked past the cap in their
    tenant are dropped from the rowspace (never selected)."""
    rng = np.random.default_rng(40 + seed)
    T = int(rng.choice([2, 3, 7]))
    L = int(rng.choice([64, 123, 300]))
    owner = rng.integers(0, T + 1, L).astype(np.int32)     # T = free
    k_max = int(rng.choice([3, 16, 64]))
    score = (rng.integers(-3, 3, L) if seed % 2
             else rng.standard_normal(L)).astype(np.float32)
    score[rng.random(L) < 0.05] = -np.inf
    active = (rng.random(L) < 0.8) & (owner < T)
    quotas = rng.integers(0, L // T + 4, T).astype(np.int32)
    foot = int(np.bincount(owner[owner < T], minlength=T).max())
    s_max = {"none": None, "below": foot // 2, "equal": foot,
             "above_L": L + 7}[cap]
    ts = TSEL.kernel_dynamic_strategy(T, k_max, impl="cuda", device="cpu",
                                      s_max=s_max)
    js = JSEL.pallas_dynamic_strategy(T, k_max, impl="pallas_ref",
                                      s_max=s_max)
    a = ts.select(T_(score), T_(owner), T_(active), T_(quotas))
    b = jax.jit(js.select)(jnp.asarray(score), jnp.asarray(owner),
                           jnp.asarray(active), jnp.asarray(quotas))
    eq(a.mask, b.mask, "mask")
    assert int(a.mask.sum()) > 0
    if cap == "below":        # a page past the cap is never selected
        rank = np.zeros(L, np.int64)
        for t in range(T):
            rank[owner == t] = np.arange(int((owner == t).sum()))
        assert not (a.mask.numpy() & (rank >= s_max) & (owner < T)).any()


# ---------------------------------------- static and dynamic, one pipeline ----
_SHARED = [
    dict(footprint=24, pattern="uniform", hot_rate=4.0, cold_rate=0.0,
         ramp=1),
    dict(footprint=32, pattern="hotcold", hot_frac=0.25, hot_rate=4.0,
         cold_rate=0.05, ramp=1, rotate_hot_every=9),
    dict(footprint=24, pattern="stream", stream_window=6, stream_step=2,
         hot_rate=3.0, cold_rate=0.05, ramp=1),
]


def _shared_runs(mode, impl):
    """The reference's constant-roster scenario
    (tests/test_tick_unification.py) through the port's static engine and
    its churn engine."""
    cfg = TCfg(n_tenants=3, n_fast_pages=40, n_slow_pages=40,
               lower_protection=(8, 8, 0), upper_bound=(0, 16, 12))
    tenants = [TW.TenantWorkload(**kw) for kw in _SHARED]
    owner, acc, alive = TW.build_trace(tenants, 48)
    s = TENG.run_engine(cfg, owner, acc, alive, mode=mode, k_max=16,
                        impl=impl, device="cpu")
    sched = TW.build_churn_schedule(
        [TW.ChurnSlot(w, [(0, 48)]) for w in tenants], 48)
    c = TCH.run_churn_engine(cfg, sched, mode=mode, k_max=16,
                             n_pages=owner.shape[0], impl=impl, device="cpu")
    return owner, s, c


@pytest.mark.parametrize("impl", ["batched", "ref"])
@pytest.mark.parametrize("mode", MODES)
def test_static_and_churn_paths_agree_on_shared_scenario(mode, impl):
    owner, (final_s, outs_s), (final_c, outs_c) = _shared_runs(mode, impl)
    for name in ("fast_usage", "slow_usage", "promotions", "demotions",
                 "attempted_promotions", "thrash_events", "fast_free",
                 "pool_free"):
        eq(getattr(outs_s, name), getattr(outs_c, name), name)
    for name in final_s.counters._fields:
        eq(getattr(final_s.counters, name), getattr(final_c.counters, name),
           f"counters.{name}")
    eq(final_s.promo_scale, final_c.promo_scale)
    eq(final_s.steady, final_c.steady)
    eq(final_s.tier, final_c.tier)
    eq(final_c.owner, owner)
    np.testing.assert_allclose(outs_s.latency.numpy(),
                               outs_c.latency.numpy(), rtol=1e-5)
    np.testing.assert_allclose(outs_s.throughput.numpy(),
                               outs_c.throughput.numpy(), rtol=1e-4)
    if mode == "equilibria":
        assert outs_s.promotions.sum() > 0 and outs_s.demotions.sum() > 0


# ----------------------------------------------------------- properties ----
_T, _S, _L, _TICKS = 4, 24, 160, 24


def _random_schedule(seed: int):
    """Adversarial lifecycle schedule (the reference's generator): per-slot
    on/off phases with the footprint resized randomly every tick."""
    rng = np.random.default_rng(seed)
    want = np.zeros((_TICKS, _T), np.int32)
    for i in range(_T):
        t = int(rng.integers(0, 6))
        while t < _TICKS:
            on = int(rng.integers(1, 12))
            for k in range(t, min(t + on, _TICKS)):
                want[k, i] = int(rng.integers(1, _S + 1))
            t += on + int(rng.integers(1, 8))
    rates = (rng.random((_TICKS, _T, _S)) * 5.0).astype(np.float32)
    rates[rng.random(rates.shape) < 0.3] = 0.0
    return want, rates


_PROP_KW = dict(n_tenants=_T, n_fast_pages=48, n_slow_pages=112,
                lower_protection=(12, 12, 0, 0), upper_bound=(0, 20, 0, 0))


@functools.lru_cache(maxsize=None)
def _reference_runner():
    tick = JCH.make_churn_tick(JCfg(**_PROP_KW), _L, mode="equilibria",
                               k_max=32)
    return (jax.jit(lambda s, r, w: jax.lax.scan(tick, s, (r, w))),
            j_init_state(JCfg(**_PROP_KW), _L))


@seeded_property(n_fallback=12, max_examples=12)
def test_conservation_under_generated_lifecycles(seed):
    """Across generated lifecycles: fast + slow + free == L every tick,
    footprints track their targets (the pool covers the roster), departed
    tenants own nothing, the owner vector agrees with the counts, thrash
    counters are monotone — and every tick equals the reference's."""
    want, rates = _random_schedule(seed)
    final, outs = TCH.run_churn_engine(
        TCfg(**_PROP_KW), TCH.ChurnSchedule(want, rates), k_max=32,
        n_pages=_L, impl="batched", device="cpu")
    fast, slow = outs.fast_usage.numpy(), outs.slow_usage.numpy()
    owned = fast + slow
    eq(fast.sum(1) + slow.sum(1) + outs.pool_free.numpy(),
       np.full(_TICKS, _L))
    eq(owned, want)
    assert (owned[want == 0] == 0).all()
    owner = final.owner.numpy()
    assert owner.min() >= 0 and owner.max() <= _T
    eq(np.bincount(owner, minlength=_T + 1)[:_T], owned[-1])
    assert (want[-1] > 0)[owner[owner < _T]].all()
    assert (np.diff(outs.thrash_events.numpy(), axis=0) >= 0).all()
    run, state = _reference_runner()
    j_final, j_outs = run(state, jnp.asarray(rates), jnp.asarray(want))
    assert_outputs_match(outs, jax.tree_util.tree_map(np.asarray, j_outs))
    eq(final.owner, j_final.owner)


@pytest.mark.parametrize("impl", ["batched", "ref"])
def test_oversubscribed_pool_truncates_in_slot_order(impl):
    cfg = TCfg(n_tenants=3, n_fast_pages=16, n_slow_pages=16)
    want = np.tile(np.array([[20, 20, 20]], np.int32), (6, 1))
    rates = np.full((6, 3, 20), 1.0, np.float32)
    _, outs = TCH.run_churn_engine(cfg, TCH.ChurnSchedule(want, rates),
                                   n_pages=32, impl=impl, device="cpu")
    owned = (outs.fast_usage + outs.slow_usage).numpy()
    assert (owned <= want).all()
    eq(owned[-1], [20, 12, 0])                       # slot priority
    eq(owned.sum(1) + outs.pool_free.numpy(), np.full(6, 32))


@pytest.mark.parametrize("impl", ["batched", "ref"])
def test_lifecycle_grant_release_depart(impl):
    """Arrival grants and allocates, shrink releases the coldest pages,
    departure returns everything to the pool."""
    cfg = TCfg(n_tenants=2, n_fast_pages=16, n_slow_pages=16)
    want = np.array([[4, 0], [4, 6], [2, 6], [0, 6]], np.int32)
    rates = np.zeros((4, 2, 8), np.float32)
    rates[:, 0, :2] = 4.0
    rates[:, 0, 2:4] = 0.1
    rates[:, 1, :6] = 1.0
    final, outs = TCH.run_churn_engine(cfg, TCH.ChurnSchedule(want, rates),
                                       n_pages=32, impl=impl, device="cpu")
    eq((outs.fast_usage + outs.slow_usage), want)
    eq(outs.pool_free, [28, 22, 24, 26])
    eq(final.counters.allocations, [4, 6])
    eq(final.counters.reclaims, [4, 0])
    owner = final.owner.numpy()
    assert (owner[:4] == 2).all()                    # FREE sentinel == T
    eq(owner[4:10], [1] * 6)


def test_churn16_preset_acceptance():
    """churn16 schedules >= 50 lifecycle events, served by one tick
    function, with conservation and clean departures."""
    ticks = 240
    cfg, slots = TSIM.CHURN_PRESETS["churn16"]()
    sched = TW.build_churn_schedule(slots, ticks)
    arrivals, departures = TCH.churn_events(sched.want)
    assert arrivals + departures >= 50
    assert TSIM.preset_churn_events("churn16", ticks) == \
        JSIM.preset_churn_events("churn16", ticks)
    r = TSIM.simulate_preset("churn16", ticks=ticks, impl="batched",
                             device="cpu")
    L = cfg.n_fast_pages + cfg.n_slow_pages
    eq(r.fast_usage.sum(1) + r.slow_usage.sum(1) + r.pool_free,
       np.full(ticks, L))
    owned = r.fast_usage + r.slow_usage
    assert (owned[~r.active] == 0).all()
    assert (owned <= sched.want).all()
    assert (np.diff(r.thrash_events, axis=0) >= 0).all()


def test_churn_generators_match_reference():
    """The port's copies of the roster generators and the schedule
    compiler give the reference's arrays and episodes."""
    def slots_of(W):
        return (W.poisson_churn(7, 200, seed=3)
                + W.serverless_bursts(5, 200, seed=4)
                + W.diurnal_roster(6, 200, seed=5)
                + W.churn_stacked(4, 3, 2, ticks=200, seed=6)
                + W.as_churn_slots(W.stacked_heterogeneous(5), 200))
    got, want = slots_of(TW), slots_of(JW)
    assert [(vars(s.workload), s.episodes) for s in got] == \
        [(vars(s.workload), s.episodes) for s in want]
    assert TW.suggest_churn_policy(got) == JW.suggest_churn_policy(want)
    a, b = TW.build_churn_schedule(got, 150), JW.build_churn_schedule(want,
                                                                      150)
    eq(a.want, b.want)
    eq(a.rates, b.rates)
    assert TCH.churn_events(a.want) == JCH.churn_events(b.want)
    tc = TSIM.churn_roster_config(got)
    jc = JSIM.churn_roster_config(want)
    assert (tc.n_fast_pages, tc.n_slow_pages, tc.lower_protection,
            tc.upper_bound) == (jc.n_fast_pages, jc.n_slow_pages,
                                jc.lower_protection, jc.upper_bound)


# ------------------------------------------- non-contiguous static owners ----
def _permuted_trace(seed=0):
    tenants = [TW.microbenchmark(40), TW.web_like(48, arrival=6),
               TW.ci_like(36, phase_len=12), TW.stream_like(30)]
    owner, acc, alive = TW.build_trace(tenants, 40)
    perm = np.random.default_rng(seed).permutation(owner.shape[0])
    return owner[perm], acc[:, perm], alive[:, perm]


_PERM_KW = dict(n_tenants=4, n_fast_pages=64, n_slow_pages=154,
                lower_protection=(16, 16, 0, 0), upper_bound=(0, 28, 0, 20))


@functools.lru_cache(maxsize=None)
def _reference_permuted(mode, impl):
    owner, acc, alive = _permuted_trace()
    final, outs = JENG.run_engine(JCfg(**_PERM_KW), owner, acc, alive,
                                  mode=mode, k_max=16, impl=impl)
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return host(final), host(outs)


@pytest.mark.parametrize("impl_t,impl_j", IMPLS)
@pytest.mark.parametrize("mode", MODES)
def test_non_contiguous_static_owner_matches_reference(mode, impl_t, impl_j):
    """A permuted owner vector takes the composite-sort path ("batched") or
    the kernels over a precomputed rowspace with mask-only selections
    ("ref"), tick by tick as the reference does."""
    owner, acc, alive = _permuted_trace()
    assert TSEL.plan_layout(owner, 4, "cpu") is None
    final, outs = TENG.run_engine(TCfg(**_PERM_KW), owner, acc, alive,
                                  mode=mode, k_max=16, impl=impl_t,
                                  device="cpu")
    want_final, want_outs = _reference_permuted(mode, impl_j)
    assert_outputs_match(outs, want_outs)
    assert_states_match(final, want_final)
    if mode != "static":
        assert outs.promotions.sum() > 0


@pytest.mark.parametrize("impl_t,impl_j", IMPLS)
@pytest.mark.parametrize("seed", range(4))
def test_non_contiguous_static_strategies_match_reference(seed, impl_t,
                                                          impl_j):
    rng = np.random.default_rng(seed)
    T = int(rng.choice([2, 3, 6]))
    owner = rng.permutation(np.repeat(np.arange(T),
                                      rng.choice([4, 17, 29], T))
                            ).astype(np.int32)
    L = owner.shape[0]
    k_max = int(rng.choice([3, 16, 64]))
    score = (rng.integers(-3, 3, L) if seed % 2
             else rng.standard_normal(L)).astype(np.float32)
    active = rng.random(L) < rng.choice([0.3, 0.8, 1.0])
    quotas = rng.integers(-1, L // T + 4, T).astype(np.int32)
    js = JSEL.static_strategy(owner, T, k_max, impl=impl_j)
    ts = TSEL.static_strategy(owner, T, k_max, impl=impl_t, device="cpu")
    a = ts.select(T_(score), T_(owner), T_(active), T_(quotas))
    b = js.select(jnp.asarray(score), jnp.asarray(owner), jnp.asarray(active),
                  jnp.asarray(quotas))
    eq(a.mask, b.mask)
    assert a.pages is None and b.pages is None and ts.move is None
    xi = rng.integers(-5, 5, L).astype(np.int32)
    eq(ts.by_tenant(T_(xi), T_(owner)),
       js.by_tenant(jnp.asarray(xi), jnp.asarray(owner)), "by_tenant")
    new = rng.random(L) < 0.4
    rb = np.asarray(js.alloc_ranks(jnp.asarray(new), jnp.asarray(owner)))
    eq(ts.alloc_ranks(T_(new), T_(owner)).numpy()[new], rb[new], "ranks")
    if ts.alloc_stats is not None:
        ranks, cnt = ts.alloc_stats(T_(new), T_(owner))
        eq(ranks.numpy()[new], rb[new], "alloc_stats ranks")
        eq(cnt, js.by_tenant(jnp.asarray(new.astype(np.int32)),
                             jnp.asarray(owner)), "alloc_stats counts")
