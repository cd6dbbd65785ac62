"""The port's streaming pathology detectors (``obs/streaming.py``, the
tick's step 9b) held against the JAX reference on seeded inputs (CPU, small
sizes).

* ``update_detector`` tick by tick from the same signals: every leaf
  bitwise (the reference runs jitted, as in its tick).
* ``streaming_pathologies`` against the reference's on the same counters,
  and against the port's offline ``detect_all`` on the same run.
* ``run_engine`` with both seams (detector and attribution ledger) in all
  four modes: the port's "batched" against the reference's "batched", the
  port's "ref" against the port's "batched". Every integer leaf (flags,
  counters, the ledger) is bitwise; the float leaves fed by the perf model
  (``det.lat_*_sum``, ``attrib.acc_*``, ``attrib.stall_sum``) are held
  within the perf model's own tolerance against the reference (rtol 1e-5,
  atol 1e-4: the port adds its per-tenant access masses in float64 and
  rounds once, ``core/select.py``) and bitwise between the port's impls.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TieringConfig as JCfg
from repro.core import engine as JENG
from repro.core import workloads as JW
from repro.obs import attribution as JAT
from repro.obs import streaming as JDS
from repro_torch import convert
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.core import engine as TENG
from repro_torch.core import workloads as TW
from repro_torch.obs import attribution as TAT
from repro_torch.obs import pathology as TPA
from repro_torch.obs import streaming as TDS

MODES = ("equilibria", "tpp", "memtis", "static")
# float leaves that sum the perf model's per-tenant outputs
PERF_FLOAT_LEAVES = {"det.lat_base_sum", "det.lat_steady_sum",
                     "attrib.acc_fast", "attrib.acc_slow", "attrib.stall_sum"}
PERF_TOL = dict(rtol=1e-5, atol=1e-4)
host = functools.partial(jax.tree_util.tree_map, np.asarray)


def _leaves(tree, prefix=""):
    """{dotted name: numpy leaf} of a reference tree or a port state dict."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else (
        (f, getattr(tree, f)) for f in tree._fields)
    for k, v in items:
        name = f"{prefix}{k}"
        if v is None:
            out[name] = None
        elif isinstance(v, dict) or hasattr(v, "_fields"):
            out.update(_leaves(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def assert_state_matches(port_state, ref_state, exact_floats=False):
    """Every leaf of a port state (single host or ``stack_hosts``) against
    a reference state with numpy leaves: bitwise, except the perf-model
    float sums (``PERF_FLOAT_LEAVES``) unless ``exact_floats``."""
    got = _leaves(convert.state_to_numpy(port_state))
    want = _leaves(ref_state)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = want[k]
        if v is None or w is None:
            assert v is None and w is None, k
            continue
        if k == "t":
            v = np.broadcast_to(v, w.shape)
        if k in PERF_FLOAT_LEAVES and not exact_floats:
            np.testing.assert_allclose(v, w, err_msg=k, **PERF_TOL)
        else:
            np.testing.assert_array_equal(v, w, err_msg=k)


def assert_states_equal(a, b):
    """Two port states, every leaf bitwise."""
    ga, gb = (_leaves(convert.state_to_numpy(s)) for s in (a, b))
    assert sorted(ga) == sorted(gb)
    for k, v in ga.items():
        if v is None:
            assert gb[k] is None, k
        else:
            np.testing.assert_array_equal(v, gb[k], err_msg=k)


# ------------------------------------------------------- detector spec ----
@pytest.mark.parametrize("horizon,kw", [
    (160, {}), (40, {}), (7, {}), (1, {}), (100, {"steady_frac": 0.0}),
    (100, {"steady_frac": 1.0}), (90, {"window": 3, "noisy_degrade": 1.5})])
def test_make_detector_matches_reference(horizon, kw):
    want = JDS.make_detector(horizon, 4, (8, 12, 0, 3), **kw)
    got = TDS.make_detector(horizon, 4, (8, 12, 0, 3), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# --------------------------------------------------- tick-by-tick update ----
def _signals(seed, ticks, T):
    """Seeded [ticks, T] telemetry with roster gaps, thrash bursts, latency
    steps and tenants held below their protection."""
    rng = np.random.default_rng(seed)
    active = rng.random((ticks, T)) < 0.9
    active[:, 0] = True
    fast = rng.integers(0, 20, (ticks, T)).astype(np.int32)
    slow = rng.integers(0, 20, (ticks, T)).astype(np.int32)
    thrash = (rng.random((ticks, T)) < 0.3) * rng.integers(0, 9, (ticks, T))
    att = rng.integers(0, 6, (ticks, T)).astype(np.int32)
    promo = np.minimum(att, rng.integers(0, 3, (ticks, T))).astype(np.int32)
    demo = rng.integers(0, 4, (ticks, T)).astype(np.int32)
    demo[:, -1] *= 6         # one tenant dominates migrations
    lat = (1.0 + rng.random((ticks, T)) * 0.5).astype(np.float32)
    lat[ticks // 2:] *= np.float32(1.3)
    return dict(active=active, thrash_new=thrash.astype(np.int32),
                fast_usage=fast, slow_usage=slow, attempted=att,
                promotions=promo, demotions=demo, latency=lat)


DETECTOR_CASES = [(0, 160, 4, {}), (1, 40, 4, {}), (2, 9, 3, {}),
                  (3, 60, 1, {}), (4, 50, 5, {"window": 1}),
                  (5, 30, 2, {"steady_frac": 1.0}),
                  (6, 30, 4, {"steady_frac": 0.0})]


@pytest.mark.parametrize("seed,ticks,T,kw", DETECTOR_CASES)
def test_update_detector_matches_reference_every_tick(seed, ticks, T, kw):
    sig = _signals(seed, ticks, T)
    prot = (12, 10, 0, 8, 5)[:T]
    jspec = JDS.make_detector(ticks, T, prot, **kw)
    tspec = TDS.make_detector(ticks, T, prot, **kw)
    j_update = jax.jit(lambda d, s, t: JDS.update_detector(jspec, d, s, t))
    jdet = JDS.init_detector(jspec)
    tdet = TDS.init_detector(tspec, device="cpu")
    for t in range(ticks):
        row = [sig[f][t] for f in JDS.DetectorSignals._fields]
        jdet = j_update(jdet, JDS.DetectorSignals(*row), np.int32(t))
        tdet = TDS.update_detector(
            tspec, tdet,
            TDS.DetectorSignals(*(torch.as_tensor(np.array(x)) for x in row)),
            t)
        for f in TDS.DetectorState._fields:
            np.testing.assert_array_equal(
                getattr(tdet, f).numpy(), np.asarray(getattr(jdet, f)),
                err_msg=f"tick {t}: {f}")
    got = TDS.streaming_pathologies(tspec, tdet)
    want = JDS.streaming_pathologies(jspec, host(jdet))
    assert [(p.kind, p.tenant, p.severity, p.evidence) for p in got] == \
        [(p.kind, p.tenant, p.severity, p.evidence) for p in want]
    # the replay helper folds the same ticks
    rep = TDS.run_detector(tspec, device="cpu", **sig)
    for f in TDS.DetectorState._fields:
        np.testing.assert_array_equal(getattr(rep, f).numpy(),
                                      getattr(tdet, f).numpy(), err_msg=f)


@pytest.mark.parametrize("seed,ticks,T,kw", DETECTOR_CASES[:3])
def test_streaming_agrees_with_offline_detectors(seed, ticks, T, kw):
    """The differential bridge: the same traces through the streaming
    replay and the offline ``detect_all`` give the same verdicts."""
    sig = _signals(seed, ticks, T)
    prot = (12, 10, 0, 8, 5)[:T]
    spec = TDS.make_detector(ticks, T, prot, **kw)
    det = TDS.run_detector(spec, device="cpu", **sig)
    got = {(p.kind, p.tenant) for p in TDS.streaming_pathologies(spec, det)}
    off = TPA.detect_all(sig["fast_usage"], sig["slow_usage"],
                         sig["promotions"], sig["demotions"], sig["latency"],
                         np.cumsum(sig["thrash_new"], axis=0),
                         attempted=sig["attempted"], lower_protection=prot,
                         active=sig["active"])
    assert got == {(p.kind, p.tenant) for p in off}


def test_streaming_pathologies_rejects_stacked_state():
    spec = TDS.make_detector(10, 2)
    det = TDS.init_detector(spec, device="cpu")
    stacked = TDS.DetectorState(*(torch.stack([x, x]) for x in det))
    with pytest.raises(ValueError, match="batched"):
        TDS.streaming_pathologies(spec, stacked)
    assert TDS.flag_summary(stacked)["flag_ticks"].shape == (2, 2, 4)


# -------------------------------------------- the static engine's seams ----
def _static_run(W, Cfg):
    """A 3-tenant static trace under fast-tier pressure with a thrasher
    arriving late (every detector kind and every ledger cause can fire)."""
    tenants = [W.web_like(48), W.cache_like(40),
               W.thrasher(32, fast_share=10, arrival=15)]
    cfg = Cfg(n_tenants=3, n_fast_pages=56, n_slow_pages=120,
              lower_protection=(20, 16, 0), upper_bound=(0, 0, 14),
              p_base=12, migration_cost=0.005)
    owner, acc, alive = W.build_trace(tenants, 60)
    return cfg, owner, acc, alive


@functools.lru_cache(maxsize=None)
def _reference_static(mode):
    cfg, owner, acc, alive = _static_run(JW, JCfg)
    det = JDS.make_detector(60, 3, cfg.lower_protection)
    att = JAT.make_attribution(3, cfg.lat_fast)
    final, outs = JENG.run_engine(cfg, owner, acc, alive, mode=mode,
                                  k_max=16, detector=det, attrib=att)
    return host(final), host(outs)


@functools.lru_cache(maxsize=None)
def _port_static(mode, impl):
    cfg, owner, acc, alive = _static_run(TW, TCfg)
    det = TDS.make_detector(60, 3, cfg.lower_protection)
    att = TAT.make_attribution(3, cfg.lat_fast)
    return TENG.run_engine(cfg, owner, acc, alive, mode=mode, k_max=16,
                           impl=impl, device="cpu", detector=det, attrib=att)


@pytest.mark.parametrize("impl", ["batched", "ref"])
@pytest.mark.parametrize("mode", MODES)
def test_run_engine_with_seams_matches_reference(mode, impl):
    final, outs = _port_static(mode, impl)
    if impl == "batched":
        want_final, want_outs = _reference_static(mode)
        assert_state_matches(final, want_final)
        for f in ("fast_usage", "slow_usage", "promotions", "demotions",
                  "attempted_promotions", "thrash_events"):
            np.testing.assert_array_equal(getattr(outs, f).numpy(),
                                          getattr(want_outs, f), err_msg=f)
    else:
        assert_states_equal(final, _port_static(mode, "batched")[0])
    assert TAT.attribution_conserved(final.attrib, final.counters)
    # the streamed verdicts equal the offline detectors' on this run
    cfg, owner, _, alive = _static_run(TW, TCfg)
    spec = TDS.make_detector(60, 3, cfg.lower_protection)
    from repro_torch.core.simulator import tenant_activity
    off = TPA.detect_all(
        outs.fast_usage.numpy(), outs.slow_usage.numpy(),
        outs.promotions.numpy(), outs.demotions.numpy(),
        outs.latency.numpy(), outs.thrash_events.numpy(),
        attempted=outs.attempted_promotions.numpy(),
        lower_protection=cfg.lower_protection,
        active=tenant_activity(owner, alive, 3))
    got = TDS.streaming_pathologies(spec, final.det)
    assert {(p.kind, p.tenant) for p in got} == \
        {(p.kind, p.tenant) for p in off}
