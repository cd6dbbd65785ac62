"""The port's fleet harness (``obs/fleet.py``) held against the JAX
reference on seeded inputs (CPU, small sizes: T=4, up to 4 hosts, up to 120
ticks).

The reference batches hosts under ``vmap``; the port advances a list of
per-host states through one tick function, host after host. The reference's
fleets run its default "batched" path, so the port's "batched" is held
against it and the port's "ref" against the port's "batched", bitwise.
Against the reference, integer leaves, flags and counters are bitwise; the
perf model's float outputs and the state leaves that sum them are held
within the perf model's tolerance (``test_torch_streaming.PERF_TOL``), and
the rollout's latency and throughput means within rtol 1e-6.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TieringConfig as JCfg
from repro.core import churn as JCH
from repro.core import workloads as JW
from repro.core.state import init_state as j_init_state
from repro.obs import attribution as JAT
from repro.obs import fleet as JF
from repro.obs import streaming as JDS
from repro_torch import convert
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.core import churn as TCH
from repro_torch.core import workloads as TW
from repro_torch.obs import attribution as TAT
from repro_torch.obs import fleet as TF
from repro_torch.obs import streaming as TDS
from test_torch_attribution import assert_sketch_matches
from test_torch_streaming import (PERF_TOL, assert_state_matches,
                                  assert_states_equal, host)

FOOT = (32, 40, 40, 24)
INT_FIELDS = ("fast_usage", "slow_usage", "promotions", "demotions",
              "thrash_events", "attempted", "active")


def _cfg(Cfg):
    total = sum(FOOT)
    return Cfg(n_tenants=4, n_fast_pages=int(total * 1.15),
               n_slow_pages=total, lower_protection=(8, 12, 12, 8),
               upper_bound=(24, 0, 0, 0), migration_cost=0.005)


def _key(ps):
    return [(p.kind, p.tenant) for p in ps]


def assert_fleet_matches(got, want, exact=False):
    """A port FleetResult against another (``exact``: every array bitwise)
    or against the reference's."""
    assert got.n_hosts == want.n_hosts and got.mode == want.mode
    assert got.lower_protection == want.lower_protection
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in ("latency", "throughput"):
        if exact:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        else:
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       err_msg=f, **PERF_TOL)
    assert [_key(p) for p in got.pathologies] == \
        [_key(p) for p in want.pathologies]
    assert got.pathology_counts() == want.pathology_counts()
    assert got.tenants_flagged() == want.tenants_flagged()
    for a, b in zip(got.stats, want.stats):
        for k, v in a.items():
            np.testing.assert_allclose(v, b[k], err_msg=k, rtol=1e-6)
    ra, rb = got.rollup(), want.rollup()
    for k, v in ra.items():
        if isinstance(v, float):
            np.testing.assert_allclose(v, rb[k], err_msg=k, **PERF_TOL)
        else:
            assert v == rb[k], k
    for h in range(got.n_hosts):
        ea, da = got.host_migrations(h)
        eb, db = want.host_migrations(h)
        assert da == db
        for f in ea.dtype.names:
            np.testing.assert_array_equal(ea[f], eb[f], err_msg=f)
    if exact:
        assert_states_equal(got._final_state, want._final_state)
    else:
        assert_state_matches(got._final_state, host(want._final_state))


# ---------------------------------------------------------- static fleet ----
def _static_mixes(W, F):
    mixes = F.heterogeneous_mixes(FOOT, 3, seed=5)
    return F.inject_noisy_neighbor(mixes, tenant=0, fast_share=12,
                                   hosts=[2], arrival=15)


@functools.lru_cache(maxsize=None)
def _run_fleet(side, impl="batched"):
    if side == "ref":
        return JF.run_fleet(_cfg(JCfg), _static_mixes(JW, JF), 60, k_max=16)
    return TF.run_fleet(_cfg(TCfg), _static_mixes(TW, TF), 60, k_max=16,
                        impl=impl, device="cpu")


@pytest.mark.parametrize("impl", ["batched", "ref"])
def test_run_fleet_matches_reference(impl):
    got = _run_fleet("port", impl)
    if impl == "batched":
        assert_fleet_matches(got, _run_fleet("ref"))
    else:
        assert_fleet_matches(got, _run_fleet("port", "batched"), exact=True)
    assert got.tenants_flagged()       # the thrasher shows


def test_run_fleet_rejects_mixed_layouts():
    mixes = [[TW.web_like(32), TW.web_like(40)],
             [TW.web_like(40), TW.web_like(32)]]
    with pytest.raises(ValueError, match="footprint layout"):
        TF.run_fleet(_cfg(TCfg), mixes, 4, device="cpu")


# ----------------------------------------------------------- mixed fleet ----
MIXED_TICKS = 120


def _mixed_hosts(W, F, ticks=MIXED_TICKS, noisy_host=3):
    """2 static + 2 churned hosts, T=4; a thrasher arriving at tick 30 on
    ``noisy_host``."""
    static_mixes = [
        [W.web_like(FOOT[0]), W.cache_like(FOOT[1]), W.spark_like(FOOT[2]),
         W.web_like(FOOT[3])],
        [W.web_like(FOOT[0], hot_pages=10), W.cache_like(FOOT[1]),
         W.web_like(FOOT[2]), W.cache_like(FOOT[3])]]
    churned = [[W.ChurnSlot(W.web_like(FOOT[0]), [(0, ticks)]),
                W.ChurnSlot(W.cache_like(FOOT[1]), [(5, ticks)]),
                W.ChurnSlot(W.cache_like(FOOT[2]),
                            [(0, 40 + 10 * seed), (70, ticks)]),
                W.ChurnSlot(W.web_like(FOOT[3]), [(8 * seed, ticks)])]
               for seed in (0, 1)]
    hosts = F.mixed_fleet_hosts(static_mixes, churned, ticks)
    if noisy_host is not None:
        hosts[noisy_host][0] = W.ChurnSlot(
            W.thrasher(FOOT[0], fast_share=12), [(30, ticks)])
    return hosts


@functools.lru_cache(maxsize=None)
def _run_mixed(side, impl="batched"):
    if side == "ref":
        return JF.run_mixed_fleet(_cfg(JCfg), _mixed_hosts(JW, JF),
                                  MIXED_TICKS, k_max=16)
    return TF.run_mixed_fleet(_cfg(TCfg), _mixed_hosts(TW, TF), MIXED_TICKS,
                              k_max=16, impl=impl, device="cpu")


@pytest.mark.parametrize("impl", ["batched", "ref"])
def test_run_mixed_fleet_matches_reference(impl):
    got = _run_mixed("port", impl)
    if impl == "batched":
        assert_fleet_matches(got, _run_mixed("ref"))
    else:
        assert_fleet_matches(got, _run_mixed("port", "batched"), exact=True)
    assert (3, 0) in got.tenants_flagged()     # the thrasher shows


def test_stack_schedules_pads_and_rejects():
    a = TW.build_churn_schedule([TW.ChurnSlot(TW.web_like(8), [(0, 5)])], 5)
    b = TW.build_churn_schedule([TW.ChurnSlot(TW.web_like(12), [(1, 5)])], 5)
    want, rates = TF.stack_schedules([a, b])
    jwant, jrates = JF.stack_schedules([a, b])
    np.testing.assert_array_equal(want, jwant)
    np.testing.assert_array_equal(rates, jrates)
    c = TW.build_churn_schedule([TW.ChurnSlot(TW.web_like(8), [(0, 6)])], 6)
    with pytest.raises(ValueError, match="slot count and horizon"):
        TF.stack_schedules([a, c])


# --------------------------------------------------------------- rollout ----
ROLL_TICKS = 60


def _archetypes(W, F):
    """Two archetypes over a period of 40 ticks on a squeezed 64-page fast
    tier (a static roster, and a churned one with a thrasher under an upper
    bound from tick 10), tiled over 60 ticks across 4 hosts."""
    static = W.as_churn_slots([W.web_like(40), W.cache_like(40),
                               W.spark_like(32), W.web_like(32)], 40)
    churned = [W.ChurnSlot(W.web_like(40), [(0, 40)]),
               W.ChurnSlot(W.cache_like(40), [(0, 40)]),
               W.ChurnSlot(W.spark_like(32), [(4, 30)]),
               W.ChurnSlot(W.thrasher(32, fast_share=10), [(10, 40)])]
    return F.stack_schedules([W.build_churn_schedule(s, 40)
                              for s in (static, churned)])


def _roll_cfg(Cfg):
    return Cfg(n_tenants=4, n_fast_pages=64, n_slow_pages=128,
               lower_protection=(4, 4, 4, 4), upper_bound=(24, 0, 0, 10),
               p_base=16)


HOST_ARCH = np.array([0, 1, 1, 0])


@functools.lru_cache(maxsize=None)
def _rollout(side, chunk, impl="batched"):
    if side == "ref":
        want, rates = _archetypes(JW, JF)
        return JF.fleet_rollout(_roll_cfg(JCfg), want, rates, ROLL_TICKS,
                                host_arch=HOST_ARCH, k_max=16, chunk=chunk)
    want, rates = _archetypes(TW, TF)
    return TF.fleet_rollout(_roll_cfg(TCfg), want, rates, ROLL_TICKS,
                            host_arch=HOST_ARCH, k_max=16, chunk=chunk,
                            impl=impl, device="cpu")


def _ledger_equal(a, b):
    ta, tb = a.ledger.total, b.ledger.total
    for f in ta["counters"]._fields:
        np.testing.assert_array_equal(getattr(ta["counters"], f),
                                      np.asarray(getattr(tb["counters"], f)),
                                      err_msg=f)
    for f in ("comp", "total"):
        np.testing.assert_array_equal(ta["att"][f], tb["att"][f], err_msg=f)


@pytest.mark.parametrize("impl", ["batched", "ref"])
@pytest.mark.parametrize("chunk", [ROLL_TICKS, 7])
def test_fleet_rollout_matches_reference(chunk, impl):
    got = _rollout("port", chunk, impl)
    assert (got.n_hosts, got.ticks, got.chunk, got.sharded) == \
        (4, ROLL_TICKS, chunk, False)
    if impl == "batched":
        want = _rollout("ref", chunk)
        ref = host(want.final_state)
        assert_state_matches(got.final_state._replace(
            attrib=got.final_state.attrib._replace(
                sketch=torch.as_tensor(np.array(ref.attrib.sketch)))), ref)
        _ledger_equal(got, want)
        np.testing.assert_array_equal(got.migrations_per_tick,
                                      want.migrations_per_tick)
        for f in ("latency_mean", "throughput_mean"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-6, err_msg=f)
        assert got.pathology_rollup() == want.pathology_rollup()
        ra, rb = got.attribution_rollup(), want.attribution_rollup()
        for k in ("stall_units_total", "component_totals", "worst_tenant",
                  "worst_tenant_stall", "conserved"):
            assert ra[k] == rb[k], k
    else:
        base = _rollout("port", chunk, "batched")
        assert_states_equal(got.final_state, base.final_state)
        _ledger_equal(got, base)
        for f in ("latency_mean", "throughput_mean", "migrations_per_tick"):
            np.testing.assert_array_equal(getattr(got, f), getattr(base, f))
    assert got.attribution_conserved()
    assert got.tenants_flagged() and got.pathology_flag_ticks().any()


def test_chunked_rollout_equals_unchunked():
    """Chunking changes only where the host reads the counters: states,
    ledger and migrations bitwise; the f32 per-chunk latency and throughput
    sums add in another association."""
    a, b = _rollout("port", 7), _rollout("port", ROLL_TICKS)
    assert_states_equal(a.final_state, b.final_state)
    _ledger_equal(a, b)
    np.testing.assert_array_equal(a.migrations_per_tick,
                                  b.migrations_per_tick)
    for f in ("latency_mean", "throughput_mean"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-6)
    np.testing.assert_array_equal(a.stall_sketch(), b.stall_sketch())
    # the sketch behind the percentiles holds the same totals as the
    # reference's, bucketed by the edges
    want = _rollout("ref", ROLL_TICKS)
    assert_sketch_matches(
        a.final_state.attrib.sketch.sum(0),
        np.asarray(want.final_state.attrib.sketch).sum(0),
        _rollout_totals())


@functools.lru_cache(maxsize=None)
def _rollout_totals():
    """The reference rollout's per-tenant-tick stall totals, [ticks, H*T]:
    its hosts' ticks replayed one at a time."""
    want, rates = _archetypes(JW, JF)
    cfg = _roll_cfg(JCfg)
    L = cfg.n_fast_pages + cfg.n_slow_pages
    att = JAT.make_attribution(4, cfg.lat_fast)
    tick = jax.jit(JCH.make_churn_tick(cfg, L, k_max=16, attrib=att))
    rows = []
    for a in HOST_ARCH:
        st = j_init_state(cfg, L, attrib=att)
        prev = np.zeros(4, np.int64)
        col = []
        for t in range(ROLL_TICKS):
            st, _ = tick(st, (rates[a, t % 40], want[a, t % 40]))
            now = np.asarray(st.attrib.total, np.int64)
            col.append(now - prev)
            prev = now
        rows.append(np.stack(col))
    return np.concatenate(rows, axis=1)


def test_rollout_flags_off_raise():
    want, rates = _archetypes(TW, TF)
    roll = TF.fleet_rollout(_roll_cfg(TCfg), want, rates, 10, k_max=16,
                            chunk=4, detect=False, attrib=False,
                            device="cpu", warmup=True)
    assert roll.final_state.attrib is None and roll.final_state.det is None
    with pytest.raises(ValueError, match="attrib=False"):
        roll.attribution_totals()
    with pytest.raises(ValueError, match="detect=False"):
        roll.host_pathologies(0)
    with pytest.raises(ValueError, match="archetypes"):
        TF.fleet_rollout(_roll_cfg(TCfg), want, rates, 4, host_arch=[0, 2],
                         device="cpu")


# --------------------------------------------------------- int32 wrap ----
@pytest.mark.parametrize("seed", range(3))
def test_counter_ledger_matches_reference_across_wrap(seed):
    rng = np.random.default_rng(seed)
    start = (2**31 - 1 - rng.integers(0, 50, (2, 4))).astype(np.int32)
    tree = {"c": start.copy()}
    jl, tl = JF.CounterLedger(tree), TF.CounterLedger(
        {"c": torch.as_tensor(start)})
    now = start.astype(np.int64)
    for _ in range(6):
        now = now + rng.integers(0, 2**30, (2, 4))
        wrapped = ((now + 2**31) % 2**32 - 2**31).astype(np.int32)
        jl.absorb({"c": wrapped})
        tl.absorb({"c": torch.as_tensor(wrapped)})
    np.testing.assert_array_equal(tl.total["c"], jl.total["c"])
    np.testing.assert_array_equal(tl.total["c"], now - start)


def test_counter_ledger_exact_across_tick_wrap():
    """Counters started next to 2**31 - 1 through ``state_from_numpy``
    wrap in the int32 state; the ledger's int64 totals stay exact."""
    want, rates = _archetypes(TW, TF)
    cfg = _roll_cfg(JCfg).with_(n_tenants=4)
    L = cfg.n_fast_pages + cfg.n_slow_pages
    det = JDS.make_detector(20, 4, cfg.lower_protection)
    att = JAT.make_attribution(4, cfg.lat_fast)
    ref = host(j_init_state(cfg, L, detector=det, attrib=att))
    near = np.full(4, 2**31 - 3, np.int32)
    ref = ref._replace(
        counters=ref.counters._replace(attempted_promotions=near.copy()),
        attrib=ref.attrib._replace(total=near.copy(),
                                   comp=np.zeros((4, 5), np.int32)
                                   + near[:, None] // 5))
    state = convert.state_from_numpy(ref, device="cpu")
    np.testing.assert_array_equal(state.counters.attempted_promotions.numpy(),
                                  near)
    tcfg = _roll_cfg(TCfg)
    tick = TCH.make_churn_tick(tcfg, L, k_max=16, impl="batched",
                               detector=TDS.make_detector(
                                   20, 4, tcfg.lower_protection),
                               attrib=TAT.make_attribution(4, tcfg.lat_fast),
                               device="cpu")
    ledger = TF.CounterLedger({"c": state.counters.attempted_promotions,
                               "total": state.attrib.total})
    grown = np.zeros(4, np.int64)
    promoted = np.zeros(4, np.int64)
    for t in range(20):
        state, out = tick(state, (torch.as_tensor(rates[1, t]),
                                  torch.as_tensor(want[1, t])))
        grown += out.attempted_promotions.numpy()
        promoted += out.promotions.numpy()
        ledger.absorb({"c": state.counters.attempted_promotions,
                       "total": state.attrib.total})
    assert (state.counters.attempted_promotions.numpy() < 0).any()  # wrapped
    assert (state.attrib.total.numpy() < 0).any()
    np.testing.assert_array_equal(ledger.total["c"], grown)
    # the ledger's growth keeps the conservation identity past the wrap
    np.testing.assert_array_equal(
        ledger.total["total"],
        grown - promoted + state.counters.reclaims.numpy())


def test_fleet_obs_smoke_property():
    """The reference's ``benchmarks/fleet_obs.py --smoke`` acceptance on the
    port: 4 hosts, 120 ticks, T=4; a thrasher under a 24-page bound from
    tick 30 is flagged (chronic thrashing and protection violation) on
    tenant 0 of every host, and the clean fleet is silent."""
    T = 4
    foot = [160, 160] + [120] * (T - 2)
    n_fast = max(int(sum(foot) * 1.15), 256)
    cfg = TCfg(n_tenants=T, n_fast_pages=n_fast, n_slow_pages=n_fast,
               lower_protection=(96,) * T, upper_bound=(0,) * T,
               migration_cost=0.005)
    mixes = TF.heterogeneous_mixes(foot, 4, seed=0)
    clean = TF.run_fleet(cfg, mixes, 120, device="cpu")
    noisy = TF.run_fleet(cfg.with_(upper_bound=(24, 0, 0, 0)),
                         TF.inject_noisy_neighbor(mixes, tenant=0,
                                                  fast_share=24, arrival=30),
                         120, device="cpu")
    assert clean.tenants_flagged() == []
    for kind in ("chronic_thrashing", "protection_violation"):
        assert {h for h, t in noisy.tenants_flagged(kind) if t == 0} == \
            set(range(4)), kind
