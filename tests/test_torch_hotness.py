"""The port's hotness providers (sampled, sketch, neomem), its count-min
sketch and its threefry draw held against the JAX reference on seeded
inputs (CPU, small sizes).

* ``core/threefry.py``: ``randint(fold_in(PRNGKey(seed), t), ...)`` equals
  ``jax.random.randint`` bitwise (jax's default threefry2x32,
  ``jax_threefry_partitionable`` on).
* ``core/cms.py``: each op bitwise against the reference's.
* The providers on stacked16 (static ownership) and churn16 (dynamic
  ownership), every tick: integer outputs and states bitwise, latency and
  throughput within rtol 1e-5 / 1e-4 (the perf model's float sums
  associate differently). The sketch runs in full coverage there, and
  outside it (a probe budget below the rowspace) on smaller hosts, where
  it draws its probes with the ported threefry.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TieringConfig as JCfg
from repro.core import churn as JCH
from repro.core import cms as JCM
from repro.core import engine as JENG
from repro.core import hotness as JHOT
from repro.core import simulator as JSIM
from repro.core import workloads as JW
from repro.core.state import init_state as j_init_state
from repro_torch import convert
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.core import churn as TCH
from repro_torch.core import cms as TCM
from repro_torch.core import engine as TENG
from repro_torch.core import hotness as THOT
from repro_torch.core import simulator as TSIM
from repro_torch.core import threefry as TF
from repro_torch.core import workloads as TW
from test_torch_churn import IMPLS, assert_outputs_match, assert_states_match

PROVIDERS = ("sampled", "sketch", "neomem")
INT_FIELDS = ("fast_usage", "slow_usage", "promotions", "demotions",
              "thrash_events", "attempted", "pool_free", "active")
FLOAT_FIELDS = ("throughput", "latency", "promo_scale")


def T_(x):
    return torch.as_tensor(np.array(x))


def eq(port, ref, msg=""):
    p = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_array_equal(p, np.asarray(ref), err_msg=msg)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ threefry ----
@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_randint_matches_jax_random(seed):
    for t in (0, 1, 2, 99, 4095, 100000):
        key_j = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        key_t = TF.fold_in(TF.prng_key(seed), t)
        for shape, lo, hi in (((16, 4), 0, 70), ((64, 64), 0, 4352),
                              ((3, 5), 0, 70000), ((7,), 0, 1),
                              ((2, 9), 5, 3), ((4, 33), -7, 2**30)):
            want = jax.random.randint(key_j, shape, lo, hi, jnp.int32)
            got = TF.randint(key_t, shape, lo, hi, "cpu")
            assert got.dtype == torch.int32
            eq(got, want, f"seed {seed} t {t} shape {shape} [{lo}, {hi})")


def test_threefry_block_and_split_match_jax():
    for seed in (0, 3, 12345):
        key = jax.random.PRNGKey(seed)
        assert tuple(int(x) for x in np.asarray(key)) == TF.prng_key(seed)
        a, b = jax.random.split(key)
        assert (tuple(int(x) for x in np.asarray(a)),
                tuple(int(x) for x in np.asarray(b))) == \
            TF.split2(TF.prng_key(seed))
        bits = jax.random.bits(key, (5, 7), jnp.uint32)
        eq(TF.random_bits(TF.prng_key(seed), (5, 7), "cpu"),
           np.asarray(bits).astype(np.int64))


# ----------------------------------------------------------------- cms ----
def _cms_case(seed):
    rng = np.random.default_rng(seed)
    depth, width = int(rng.choice([1, 2, 4])), int(rng.choice([16, 256]))
    decay = float(rng.choice([1.0, 0.85]))
    n = int(rng.choice([1, 40, 300]))
    pages = rng.integers(0, 2000, (3, n)).astype(np.int32)  # collisions
    amounts = (rng.random((3, n)) * 5).astype(np.float32)
    valid = rng.random((3, n)) < 0.7
    cms = (rng.random((depth, width)) * 9).astype(np.float32)
    return (depth, width, decay, seed), pages, amounts, valid, cms


@pytest.mark.parametrize("seed", range(6))
def test_cms_ops_match_reference(seed):
    (depth, width, decay, pseed), pages, amounts, valid, cms = \
        _cms_case(seed)
    pj = JCM.cms_params(depth, width, decay, pseed)
    pt = TCM.cms_params(depth, width, decay, pseed, device="cpu")
    eq(pt.mults, pj.mults, "mults")
    eq(pt.offs, pj.offs, "offs")
    eq(TCM.make_cms(pt), JCM.make_cms(pj), "make_cms")
    jc, tc = jnp.asarray(cms), T_(cms)
    jp, tp = jnp.asarray(pages), T_(pages)
    eq(TCM.cms_hash(pt, tp), JCM.cms_hash(pj, jp), "hash")
    eq(TCM.cms_add(pt, tc, tp, T_(amounts), T_(valid)),
       jax.jit(lambda c, p, a, v: JCM.cms_add(pj, c, p, a, v))(
           jc, jp, jnp.asarray(amounts), jnp.asarray(valid)), "add")
    # assign is sound on distinct buckets: one lane per page window
    distinct = np.arange(min(width, pages.size), dtype=np.int32)
    vals = (np.arange(distinct.size) * 0.5).astype(np.float32)
    dv = np.ones(distinct.size, bool)
    dv[::3] = False
    eq(TCM.cms_assign(pt, tc, T_(distinct), T_(vals), T_(dv)),
       jax.jit(lambda c, p, a, v: JCM.cms_assign(pj, c, p, a, v))(
           jc, jnp.asarray(distinct), jnp.asarray(vals), jnp.asarray(dv)),
       "assign")
    eq(TCM.cms_clear(pt, tc, tp, T_(valid)),
       jax.jit(lambda c, p, v: JCM.cms_clear(pj, c, p, v))(
           jc, jp, jnp.asarray(valid)), "clear")
    eq(TCM.cms_decay(pt, tc), jax.jit(lambda c: JCM.cms_decay(pj, c))(jc),
       "decay")
    eq(TCM.cms_merge(tc, tc), JCM.cms_merge(jc, jc), "merge")
    eq(TCM.cms_estimate(pt, tc, tp),
       jax.jit(lambda c, p: JCM.cms_estimate(pj, c, p))(jc, jp), "estimate")


@pytest.mark.parametrize("seed", range(4))
def test_topn_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    T, M = 5, int(rng.choice([3, 40, 200]))
    score = rng.integers(-4, 4, (T, M)).astype(np.float32)    # ties
    page = rng.permutation(T * M).reshape(T, M).astype(np.int32)
    valid = rng.random((T, M)) < 0.6
    for n in (1, 8, M + 7):
        pg, vals = TCM.topn_rows(T_(score), T_(page), T_(valid), n)
        pj, vj = JCM.topn_rows(jnp.asarray(score), jnp.asarray(page),
                               jnp.asarray(valid), n)
        eq(pg, pj, f"pages n={n}")
        eq(vals, vj, f"scores n={n}")


def test_sketch_asserts_int32_hash_range():
    cfg = TCfg(n_tenants=2)
    with pytest.raises(AssertionError):
        THOT.sketch_hotness(cfg, 3_000_000, 64, THOT.SketchSpec())


def test_resolve_hotness_names():
    cfg = TCfg(n_tenants=2)
    for name in THOT.HOTNESS_PROVIDERS:
        assert THOT.resolve_hotness(name, cfg, 64, 16).name == name
    assert THOT.resolve_hotness(None, cfg, 64, 16).name == "exact"
    with pytest.raises(ValueError, match="unknown hotness provider"):
        THOT.resolve_hotness("lru", cfg, 64, 16)
    assert THOT.init_hotness("exact", cfg, 64, device="cpu") is None
    st = THOT.init_hotness("sketch", cfg, 64, device="cpu")
    assert st.cms.shape == (2, 1 << 15) and st.cand_page.shape == (2, 128)


# -------------------------------------------------------- the providers ----
@functools.lru_cache(maxsize=None)
def _reference_stacked16(hotness, impl):
    cfg, tenants = JSIM.PRESETS["stacked16"]()
    return JSIM.simulate(cfg, tenants, 60, k_max=128, impl=impl,
                         hotness=hotness)


def _assert_sims_match(got, want):
    for f in INT_FIELDS:
        eq(getattr(got, f), getattr(want, f), f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, atol=1e-4, err_msg=f)
    eq(got.migrations, want.migrations, "ring")
    for k, v in want.tier_stats.items():
        eq(got.tier_stats[k], v, k)


@pytest.mark.parametrize("impl_t,impl_j", IMPLS)
@pytest.mark.parametrize("hotness", PROVIDERS)
def test_providers_on_stacked16_match_reference(hotness, impl_t, impl_j):
    """Static ownership (contiguous): the sketch's compact buffer
    selections go through K4's plain version under "ref"."""
    want = _reference_stacked16(hotness, impl_j)
    got = TSIM.simulate_preset("stacked16", ticks=60, k_max=128,
                               hotness=hotness, impl=impl_t, device="cpu")
    _assert_sims_match(got, want)
    assert got.promotions.sum() > 0 and got.demotions.sum() > 0


@functools.lru_cache(maxsize=None)
def _reference_churn16(hotness, impl):
    cfg, slots = JSIM.CHURN_PRESETS["churn16"]()
    return JSIM.simulate_churn(cfg, slots, 60, k_max=64, hotness=hotness,
                               impl=impl)


@pytest.mark.parametrize("impl_t,impl_j", IMPLS)
@pytest.mark.parametrize("hotness", PROVIDERS)
def test_providers_on_churn16_match_reference(hotness, impl_t, impl_j):
    """Dynamic ownership: the providers read the tenant rowspace the tick
    scatters from the live owner vector."""
    want = _reference_churn16(hotness, impl_j)
    got = TSIM.simulate_preset("churn16", ticks=60, k_max=64,
                               hotness=hotness, impl=impl_t, device="cpu")
    _assert_sims_match(got, want)
    assert got.promotions.sum() > 0


# a probe budget below each tenant's rowspace: the sketch draws its probe
# lanes (threefry) and merges them into its buffers
SPARSE = dict(depth=2, width=1 << 9, n_cand=12, n_cold=16, probe=24, seed=5)


def _sparse_static(W, Cfg):
    tenants = [W.microbenchmark(40), W.web_like(48, arrival=4),
               W.ci_like(36, phase_len=12), W.stream_like(30),
               W.cache_like(44, arrival=7)]
    prot, bound = W.suggest_policy(tenants)
    cfg = Cfg(n_tenants=5, n_fast_pages=96, n_slow_pages=198,
              lower_protection=prot, upper_bound=bound)
    return cfg, W.build_trace(tenants, 50)


@pytest.mark.parametrize("impl_t,impl_j", IMPLS)
def test_sketch_outside_full_coverage_static_matches_reference(impl_t,
                                                               impl_j):
    cfg_j, (owner, acc, alive) = _sparse_static(JW, JCfg)
    spec_j = JHOT.SketchSpec(**SPARSE)
    jf, jo = JENG.run_engine(cfg_j, owner, acc, alive, k_max=16,
                             impl=impl_j, hotness=spec_j)
    cfg_t, _ = _sparse_static(TW, TCfg)
    spec_t = THOT.SketchSpec(**SPARSE)
    assert spec_t.probe // cfg_t.n_tenants < 40        # r < S: draws
    tf, to = TENG.run_engine(cfg_t, owner, acc, alive, k_max=16,
                             impl=impl_t, device="cpu", hotness=spec_t)
    assert_outputs_match(to, host(jo))
    assert_states_match(tf, host(jf))
    assert to.promotions.sum() > 0


@pytest.mark.parametrize("impl_t,impl_j", IMPLS)
def test_sketch_outside_full_coverage_churn_matches_reference(impl_t,
                                                              impl_j):
    def build(W):
        return W.churn_stacked(2, 3, 2, ticks=50, seed=2)
    sched_j = JW.build_churn_schedule(build(JW), 50)
    cfg_j = JSIM.churn_roster_config(build(JW))
    jf, jo = JCH.run_churn_engine(cfg_j, sched_j, k_max=16, impl=impl_j,
                                  hotness=JHOT.SketchSpec(**SPARSE))
    sched_t = TW.build_churn_schedule(build(TW), 50)
    cfg_t = TSIM.churn_roster_config(build(TW))
    tf, to = TCH.run_churn_engine(cfg_t, sched_t, k_max=16, impl=impl_t,
                                  device="cpu",
                                  hotness=THOT.SketchSpec(**SPARSE))
    assert sched_t.rates.shape[2] > SPARSE["probe"] // cfg_t.n_tenants
    assert_outputs_match(to, host(jo))
    assert_states_match(tf, host(jf))


@pytest.mark.parametrize("hotness", ("exact",) + PROVIDERS)
def test_one_tick_from_reference_state_with_provider_state(hotness):
    """The reference's state after 20 ticks (its hotness subtree
    included) handed to the port: one port tick equals the reference's
    tick 21."""
    cfg_j, (owner, acc, alive) = _sparse_static(JW, JCfg)
    spec = SPARSE if hotness == "sketch" else None
    hj = JHOT.SketchSpec(**spec) if spec else hotness
    ht = THOT.SketchSpec(**spec) if spec else hotness
    tick_j = JENG.make_tick(cfg_j, owner, k_max=16, hotness=hj)
    state = j_init_state(cfg_j, owner.shape[0], owner=owner, hotness=hj)
    run = jax.jit(lambda s, a, v: jax.lax.scan(tick_j, s, (a, v)))
    s20, _ = run(state, jnp.asarray(acc[:20]), jnp.asarray(alive[:20]))
    s21, o21 = run(state, jnp.asarray(acc[:21]), jnp.asarray(alive[:21]))
    cfg_t, _ = _sparse_static(TW, TCfg)
    tick_t = TENG.make_tick(cfg_t, owner, k_max=16, impl="batched",
                            device="cpu", hotness=ht)
    ts = convert.state_from_numpy(host(s20), device="cpu")
    if hotness == "exact":
        assert ts.hotness is None
    new, out = tick_t(ts, (T_(acc[20]), T_(alive[20])))
    assert_outputs_match(out, host(jax.tree_util.tree_map(
        lambda x: x[20], o21)))
    assert_states_match(new, host(s21))


def test_sketch_full_coverage_equals_exact():
    """In full coverage with an injective hash the sketch's estimates are
    the exact EWMA, so its runs equal the exact provider's bitwise (the
    reference's differential pin)."""
    cfg = TCfg(n_tenants=3, n_fast_pages=64, n_slow_pages=128,
               lower_protection=(16, 16, 0), upper_bound=(0, 32, 0))
    tenants = [TW.microbenchmark(40), TW.web_like(48, arrival=8),
               TW.ci_like(36, phase_len=16)]
    a = TSIM.simulate(cfg, tenants, 60, device="cpu")
    b = TSIM.simulate(cfg, tenants, 60, hotness="sketch", device="cpu")
    for f in ("promotions", "demotions", "attempted", "latency",
              "fast_usage", "slow_usage", "thrash_events", "pool_free"):
        eq(getattr(b, f), getattr(a, f), f)
