"""The port's slowdown-attribution ledger (``obs/attribution.py``, the
tick's step 9c), its quantile sketch (``obs/sketch.py``) and the
counterfactual harness (``obs/counterfactual.py``) held against the JAX
reference on seeded inputs (CPU, small sizes).

The sketch diverges from the reference on purpose: the reference's jitted
``sketch_bucket`` takes a float32 ``log2`` that XLA returns one ulp low at
256, 512, 8192 and 32768, so those values land one bucket below their edge
(ref ``obs/sketch.py:47`` against ``sketch_edges``, ``:69``); the port
buckets by the edges. The per-tick stall totals behind the sketch are
compared bitwise, the port's sketch against the port's own ``sketch_add``
of the reference's totals, and against the reference's sketch only where
the reference's bucket differs from the edge.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TieringConfig as JCfg
from repro.core import churn as JCH
from repro.core import workloads as JW
from repro.core.state import init_state as j_init_state
from repro.obs import attribution as JAT
from repro.obs import counterfactual as JCF
from repro.obs import sketch as JSK
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.core import churn as TCH
from repro_torch.core import workloads as TW
from repro_torch.obs import attribution as TAT
from repro_torch.obs import counterfactual as TCF
from repro_torch.obs import sketch as TSK
from test_torch_streaming import (MODES, PERF_TOL, assert_state_matches,
                                  assert_states_equal, host)

ALL_INTS = np.arange(1 << 17)


def exact_bucket(values) -> np.ndarray:
    """The bucket whose [lower edge, next edge) holds each value, from
    ``sketch_edges`` alone."""
    edges = TSK.sketch_edges()[:TSK.SKETCH_BUCKETS]
    v = np.maximum(np.asarray(values, np.float64), 0.0)
    return np.clip(np.searchsorted(edges, v, side="right") - 1, 0,
                   TSK.SKETCH_BUCKETS - 1)


@functools.lru_cache(maxsize=None)
def reference_buckets() -> np.ndarray:
    return np.asarray(jax.jit(JSK.sketch_bucket)(jnp.asarray(ALL_INTS)))


def off_edge_values() -> np.ndarray:
    """Integers in [0, 2**17) that the reference buckets apart from the
    edges."""
    return ALL_INTS[reference_buckets() != exact_bucket(ALL_INTS)]


# --------------------------------------------------------------- sketch ----
def test_sketch_bucket_is_exact_edges():
    """Every integer in [0, 2**17) lands in the bucket of its edges (the
    port's deliberate divergence from the reference's float log2)."""
    got = TSK.sketch_bucket(torch.as_tensor(ALL_INTS, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), exact_bucket(ALL_INTS))
    np.testing.assert_array_equal(TSK.sketch_edges(), JSK.sketch_edges())
    assert TSK.SKETCH_BUCKETS == JSK.SKETCH_BUCKETS
    # the reference is one bucket low exactly where it diverges, and the
    # smallest such per-tenant-tick stall total is 256
    off = off_edge_values()
    assert off.size and int(off.min()) == 256
    np.testing.assert_array_equal(reference_buckets()[off],
                                  exact_bucket(off) - 1)
    # negatives clamp to bucket 0, values past the range to the last one
    edge = torch.tensor([-5.0, 0.5, 127.99, 1e9])
    assert TSK.sketch_bucket(edge).tolist() == [0, 0, 127,
                                                TSK.SKETCH_BUCKETS - 1]


@pytest.mark.parametrize("seed", range(3))
def test_sketch_host_side_matches_reference(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, (3, TSK.SKETCH_BUCKETS)).astype(np.int32)
    counts[:, rng.random(TSK.SKETCH_BUCKETS) < 0.5] = 0
    qs = (0.0, 0.5, 0.9, 0.95, 0.99, 1.0)
    np.testing.assert_array_equal(TSK.sketch_merge(torch.as_tensor(counts)),
                                  JSK.sketch_merge(counts))
    assert TSK.sketch_count(counts) == JSK.sketch_count(counts)
    np.testing.assert_array_equal(TSK.sketch_percentiles(counts, qs),
                                  JSK.sketch_percentiles(counts, qs))
    assert TSK.sketch_percentile(np.zeros(TSK.SKETCH_BUCKETS), 0.5) == 0.0
    # weighted adds: integer weights, duplicates in any order
    vals = rng.integers(0, 1 << 16, 64)
    w = rng.integers(0, 5, 64)
    got = TSK.sketch_add(TSK.init_sketch(device="cpu"), torch.as_tensor(vals),
                         torch.as_tensor(w))
    want = np.zeros(TSK.SKETCH_BUCKETS, np.int64)
    np.add.at(want, exact_bucket(vals), w)
    np.testing.assert_array_equal(got.numpy(), want)


def sketch_of(totals) -> np.ndarray:
    """The port's sketch of a run of [ticks, T] per-tick totals, folded tick
    by tick through its own ``sketch_add``."""
    sk = TSK.init_sketch(device="cpu")
    for row in np.asarray(totals):
        sk = TSK.sketch_add(sk, torch.as_tensor(row))
    return sk.numpy()


def assert_sketch_matches(port_sketch, ref_sketch, totals):
    """The port's sketch equals its own fold of the reference's per-tick
    totals; against the reference's sketch it differs only by the totals
    the reference buckets apart from the edges."""
    np.testing.assert_array_equal(np.asarray(port_sketch), sketch_of(totals))
    flat = np.asarray(totals).reshape(-1)
    off = np.isin(flat, off_edge_values())
    moved = np.zeros(TSK.SKETCH_BUCKETS, np.int64)
    np.add.at(moved, exact_bucket(flat[off]), 1)
    np.add.at(moved, reference_buckets()[flat[off]], -1)
    np.testing.assert_array_equal(
        np.asarray(port_sketch, np.int64) - np.asarray(ref_sketch, np.int64),
        moved)


# ------------------------------------------------------ the ledger ops ----
def _signals(rng, T, spill=False):
    """One tick's seeded signals: a cascade cand >= base >= eq2 >= mit, a
    promoted count under it (over it with ``spill``: tpp's global
    selection), reclaims, access masses and latencies."""
    i = np.int32
    cand = rng.integers(0, 600, T).astype(i)
    cand[rng.random(T) < 0.2] = 0
    base = np.minimum(cand, rng.integers(0, 300, T)).astype(i)
    eq2 = np.minimum(base, rng.integers(0, 300, T)).astype(i)
    mit = np.minimum(eq2, rng.integers(0, 300, T)).astype(i)
    promoted = (np.minimum(cand, mit + rng.integers(0, 40, T)) if spill
                else np.minimum(mit, rng.integers(0, 300, T))).astype(i)
    freed = (rng.integers(0, 80, T) * (rng.random(T) < 0.3)).astype(i)
    f = np.float32
    return (cand, promoted, base, eq2, mit, freed,
            (rng.random(T) * 50).astype(f), (rng.random(T) * 50).astype(f),
            (0.5 + rng.random(T) * 2).astype(f))


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_attribution_components_match_reference(seed, spill):
    rng = np.random.default_rng(seed)
    sig = _signals(rng, 16, spill)
    got = TAT.attribution_components(TAT.AttribSignals(
        *(torch.as_tensor(x) for x in sig)))
    want = jax.jit(JAT.attribution_components)(JAT.AttribSignals(*sig))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(-1).numpy() == sig[0] - sig[1] + sig[5]).all()


@pytest.mark.parametrize("spill", [False, True])
def test_update_attribution_matches_reference_every_tick(spill):
    rng = np.random.default_rng(7)
    T, ticks = 8, 40
    jspec = JAT.make_attribution(T, 1.0)
    tspec = TAT.make_attribution(T, 1.0)
    j_update = jax.jit(lambda a, s: JAT.update_attribution(jspec, a, s))
    jatt = JAT.init_attribution(jspec)
    tatt = TAT.init_attribution(tspec, device="cpu")
    totals = []
    for t in range(ticks):
        sig = _signals(rng, T, spill)
        if t == 3:       # totals the reference buckets off its edges
            sig[0][:4] = (256, 512, 8192, 32768)
            for x in sig[1:6]:
                x[:4] = 0
        jatt = j_update(jatt, JAT.AttribSignals(*sig))
        tatt = TAT.update_attribution(
            tspec, tatt, TAT.AttribSignals(*(torch.as_tensor(x)
                                             for x in sig)))
        totals.append(sig[0] - sig[1] + sig[5])
        for f in TAT.AttributionState._fields:
            if f != "sketch":
                np.testing.assert_array_equal(
                    getattr(tatt, f).numpy(), np.asarray(getattr(jatt, f)),
                    err_msg=f"tick {t}: {f}")
    assert_sketch_matches(tatt.sketch, jatt.sketch, totals)
    assert not np.array_equal(tatt.sketch.numpy(), np.asarray(jatt.sketch))
    for key, v in TAT.attribution_summary(tspec, tatt).items():
        w = JAT.attribution_summary(jspec, host(jatt))[key]
        if key == "component_names" or key == "ticks":
            assert v == w
        else:
            np.testing.assert_array_equal(v, w, err_msg=key)


def test_host_side_views():
    spec = TAT.make_attribution(3)
    att = TAT.init_attribution(spec, device="cpu")
    np.testing.assert_array_equal(TAT.fast_hit_fraction(att), np.ones(3))
    stacked = TAT.AttributionState(*(torch.stack([x, x]) for x in att))
    with pytest.raises(ValueError, match="batched"):
        TAT.attribution_summary(spec, stacked)
    assert TAT.attribution_conserved(stacked)


# ------------------------------------ the churn engine with both seams ----
def _cascade(W, Cfg, CH, ticks=100):
    """4 slots over a 64-page fast tier with a late thrasher under an upper
    bound: every ledger cause (hot_resident, throttled, mitigated,
    reclaim, contention) accumulates stall in equilibria."""
    slots = [W.ChurnSlot(W.web_like(40), [(0, ticks)]),
             W.ChurnSlot(W.cache_like(40), [(0, ticks)]),
             W.ChurnSlot(W.spark_like(32), [(4, 70)]),
             W.ChurnSlot(W.thrasher(32, fast_share=10), [(ticks // 5, ticks)])]
    cfg = Cfg(n_tenants=4, n_fast_pages=64, n_slow_pages=128,
              lower_protection=(4, 4, 4, 4), upper_bound=(24, 0, 0, 10),
              p_base=16)
    return cfg, W.build_churn_schedule(slots, ticks)


def _specs(DS, AT, cfg, ticks):
    return (DS.make_detector(ticks, cfg.n_tenants, cfg.lower_protection),
            AT.make_attribution(cfg.n_tenants, cfg.lat_fast))


@functools.lru_cache(maxsize=None)
def _reference_churn(mode):
    """The reference's churn engine with both seams, plus the ledger's
    cumulative totals after every tick."""
    from repro.obs import streaming as JDS
    cfg, sched = _cascade(JW, JCfg, JCH)
    det, att = _specs(JDS, JAT, cfg, 100)
    L = cfg.n_fast_pages + cfg.n_slow_pages
    tick = JCH.make_churn_tick(cfg, L, mode=mode, k_max=16, detector=det,
                               attrib=att)

    def body(s, x):
        s, out = tick(s, x)
        return s, (out, s.attrib.total)

    final, (outs, totals) = jax.jit(lambda s, r, w: jax.lax.scan(
        body, s, (r, w)))(j_init_state(cfg, L, detector=det, attrib=att),
                          jnp.asarray(sched.rates), jnp.asarray(sched.want))
    return host(final), host(outs), np.diff(np.asarray(totals), axis=0,
                                            prepend=0)


@functools.lru_cache(maxsize=None)
def _port_churn(mode, impl):
    from repro_torch.obs import streaming as TDS
    cfg, sched = _cascade(TW, TCfg, TCH)
    det, att = _specs(TDS, TAT, cfg, 100)
    return TCH.run_churn_engine(cfg, sched, mode=mode, k_max=16,
                                detector=det, attrib=att, impl=impl,
                                device="cpu")


@pytest.mark.parametrize("impl", ["batched", "ref"])
@pytest.mark.parametrize("mode", MODES)
def test_run_churn_engine_with_seams_matches_reference(mode, impl):
    final, outs = _port_churn(mode, impl)
    want_final, want_outs, totals = _reference_churn(mode)
    if impl == "batched":
        port = final._replace(attrib=final.attrib._replace(
            sketch=torch.as_tensor(np.array(want_final.attrib.sketch))))
        assert_state_matches(port, want_final)
        for f in ("fast_usage", "slow_usage", "promotions", "demotions",
                  "attempted_promotions", "thrash_events", "pool_free"):
            np.testing.assert_array_equal(getattr(outs, f).numpy(),
                                          getattr(want_outs, f), err_msg=f)
    else:
        assert_states_equal(final, _port_churn(mode, "batched")[0])
    assert_sketch_matches(final.attrib.sketch, want_final.attrib.sketch,
                          totals)
    assert TAT.attribution_conserved(final.attrib, final.counters)
    comp = final.attrib.comp.numpy()
    assert comp.sum() > 0 and (comp >= 0).all()
    if mode == "equilibria":     # every cause accumulates stall here
        assert (comp.sum(0) > 0).all(), comp.sum(0)


# ------------------------------------------------------ counterfactuals ----
@functools.lru_cache(maxsize=None)
def _reference_counterfactual():
    cfg, sched = _cascade(JW, JCfg, JCH, ticks=60)
    return JCF.counterfactual_run(cfg, sched, k_max=16)


@functools.lru_cache(maxsize=None)
def _port_counterfactual(impl):
    cfg, sched = _cascade(TW, TCfg, TCH, ticks=60)
    return TCF.counterfactual_run(cfg, sched, k_max=16, impl=impl,
                                  device="cpu")


@pytest.mark.parametrize("impl", ["batched", "ref"])
def test_counterfactual_run_matches_reference(impl):
    got = _port_counterfactual(impl)
    if impl == "batched":
        want = _reference_counterfactual()
        for part in ("stacked_state", "isolated_states"):
            ref = host(getattr(want, part))
            port = getattr(got, part)
            # the reference's sketch buckets; the totals behind it are
            # already held bitwise by the engine test above
            port = port._replace(attrib=port.attrib._replace(
                sketch=torch.as_tensor(np.array(ref.attrib.sketch))))
            assert_state_matches(port, ref)
        np.testing.assert_array_equal(got.active, want.active)
        for f in ("fast_hit_stacked", "fast_hit_isolated", "interference",
                  "stall_stacked", "stall_isolated"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       err_msg=f, **PERF_TOL)
    else:
        base = _port_counterfactual("batched")
        assert_states_equal(got.stacked_state, base.stacked_state)
        assert_states_equal(got.isolated_states, base.isolated_states)
        np.testing.assert_array_equal(got.interference, base.interference)
    want_iso, _ = TCF.isolate_schedules(_cascade(TW, TCfg, TCH, 60)[1])
    assert want_iso.shape[0] == 4
    s = got.summary()
    assert s["active_tenants"] == 4 and s["max_interference"] >= 0.0
