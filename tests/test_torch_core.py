"""The port's policy, telemetry, selection and tick held against the JAX
reference on seeded numpy inputs (CPU, small sizes).

Integers are compared with ``array_equal``; floats bitwise where the port
reproduces the reference's arithmetic (the fused multiply-add of the EWMA
and the windowed rates, ``(r*r)*(r*r)`` for Eq. 2), and within a stated
tolerance only where the reference's float association cannot be
reproduced (the cumsum of the f32 per-tenant perf-model sums).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TieringConfig as JCfg
from repro.core import hotness as JHOT
from repro.core import policy as JP
from repro.core import select as JSEL
from repro.core.engine import run_engine as j_run_engine
from repro.core.state import TenantPolicy as JPol
from repro.core.state import ThrashTable as JTable
from repro.core.state import init_state as j_init_state
from repro.core.workloads import build_trace, ci_like, microbenchmark
from repro.obs import stats as JOS
from repro.obs import trace as JOT
from repro_torch import convert
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.core import hotness as THOT
from repro_torch.core import policy as TP
from repro_torch.core import select as TSEL
from repro_torch.core.engine import make_tick as t_make_tick
from repro_torch.core.state import TenantPolicy as TPol
from repro_torch.core.state import ThrashTable as TTable
from repro_torch.obs import stats as TOS
from repro_torch.obs import trace as TOT


def T_(x):
    return torch.as_tensor(np.array(x))


def eq(port, ref, msg=""):
    p = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_array_equal(p, np.asarray(ref), err_msg=msg)


# The reference's tick runs jitted, and XLA fuses multiply-adds only under
# jit, so every reference call that holds float arithmetic is jitted here.
j_upper_bound = jax.jit(JP.upper_bound_demotion)


def j_eq2(p_base, usage, pol, contended, cfg):
    return jax.jit(lambda *a: JP.eq2_promotion_scan(*a, cfg))(
        p_base, usage, pol, contended)


def _policy_inputs(seed, T=64):
    rng = np.random.default_rng(seed)
    usage = rng.integers(0, 5000, T).astype(np.int32)
    usage[:3] = (0, 1, 4096)
    prot = np.where(rng.random(T) < 0.5, rng.integers(1, 3000, T), 0
                    ).astype(np.int32)
    bound = np.where(rng.random(T) < 0.5, rng.integers(1, 6000, T), 0
                     ).astype(np.int32)
    return rng, usage, prot, bound


# ---------------------------------------------------------------- policy ----
@pytest.mark.parametrize("seed", range(6))
def test_policy_equations_match_reference(seed):
    rng, usage, prot, bound = _policy_inputs(seed)
    cfg_j, cfg_t = JCfg(), TCfg()
    jp, tp = JPol(jnp.asarray(prot), jnp.asarray(bound)), \
        TPol(T_(prot), T_(bound))
    for contended in (True, False):
        cj, ct = jnp.asarray(contended), torch.tensor(contended)
        eq(TP.eq1_demotion_scan(T_(usage), T_(usage), tp, ct),
           JP.eq1_demotion_scan(jnp.asarray(usage), jnp.asarray(usage), jp,
                                cj), "eq1")
        p_base = rng.integers(1, 300, usage.shape[0]).astype(np.float32)
        pj, thj = j_eq2(jnp.asarray(p_base), jnp.asarray(usage), jp, cj,
                        cfg_j)
        pt, tht = TP.eq2_promotion_scan(T_(p_base), T_(usage), tp, ct, cfg_t)
        eq(pt, pj, "eq2 p_scan")
        eq(tht, thj, "eq2 throttled")
    eq(TP.upper_bound_demotion(T_(usage), tp),
       j_upper_bound(jnp.asarray(usage), jp), "upper bound")


def test_eq2_fourth_power_is_bitwise():
    """ratio ** 4 lowers to (r*r)*(r*r) in the reference; the quota is then
    truncated to an integer, so the port must agree bit for bit."""
    rng = np.random.default_rng(7)
    n = 1 << 14
    usage = rng.integers(1, 20000, n).astype(np.int32)
    prot = rng.integers(1, 20000, n).astype(np.int32)
    bound = np.zeros(n, np.int32)
    p_base = np.full(n, 256.0, np.float32)
    pj, _ = j_eq2(jnp.asarray(p_base), jnp.asarray(usage),
                  JPol(jnp.asarray(prot), jnp.asarray(bound)),
                  jnp.asarray(True), JCfg())
    pt, _ = TP.eq2_promotion_scan(T_(p_base), T_(usage),
                                  TPol(T_(prot), T_(bound)),
                                  torch.tensor(True), TCfg())
    eq(pt, pj)
    eq(pt.to(torch.int32), np.asarray(pj).astype(np.int32))


def test_upper_bound_thresholds_over_all_small_bounds():
    bound = np.arange(0, 20000, dtype=np.int32)
    usage = (bound * 0.95).astype(np.int32)
    jp = JPol(jnp.zeros_like(jnp.asarray(bound)), jnp.asarray(bound))
    tp = TPol(torch.zeros(bound.shape[0], dtype=torch.int32), T_(bound))
    eq(TP.upper_bound_demotion(T_(usage), tp),
       j_upper_bound(jnp.asarray(usage), jp))


SEL_FIELDS = ("mask", "pages", "take", "counts")


@pytest.mark.parametrize("impl_t,impl_j", [("batched", "batched"),
                                           ("ref", "pallas_ref")])
def test_ewma_fused_multiply_add_and_dense_view(impl_t, impl_j):
    """The EWMA ``where(alive, 0.85*prev + acc, 0)`` rounds once: the
    reference's tick runs under ``jit``, where XLA fuses the multiply-add
    (run eagerly, op by op, it rounds twice, as eager torch does). One ulp
    flips threshold compares and top-k orders, so hot, demand and every
    selection must agree bitwise with the jitted reference."""
    L, T, t = 4096, 8, 60
    rng = np.random.default_rng(3)
    owner = np.repeat(np.arange(T, dtype=np.int32), L // T)
    prev = (rng.random(L) * 40).astype(np.float32)
    acc = np.where(rng.random(L) < 0.3, 4.0, rng.random(L) * 0.3
                   ).astype(np.float32)
    alive = rng.random(L) < 0.9
    tier = rng.integers(-1, 2, L).astype(np.int32)
    last = rng.integers(0, 50, L).astype(np.int32)
    quotas = rng.integers(0, 80, T).astype(np.int32)
    fast = tier == 0
    ctx = dict(prev_hot=prev, accesses=acc, alive=alive,
               new=np.zeros(L, bool), tier=tier, last_access=last,
               owner=owner, owner_c=owner)
    js = JSEL.static_strategy(owner, T, 64, impl=impl_j)
    ts = TSEL.static_strategy(owner, T, 64, impl=impl_t, device="cpu")

    @jax.jit
    def ref_view(arrays, fast, quotas):
        v = JHOT.exact_hotness(JCfg(n_tenants=T), L, 64).step(JHOT.HotCtx(
            hstate=None, **arrays, t=jnp.int32(t), rows=None, strategy=js))
        return (v.hot, v.demand_t, v.demote(fast, quotas),
                v.promo_cand(arrays["tier"], fast).select(quotas),
                v.demote_global(fast, jnp.int32(300)).mask)

    want = jax.tree_util.tree_map(np.asarray, ref_view(
        {k: jnp.asarray(v) for k, v in ctx.items()}, jnp.asarray(fast),
        jnp.asarray(quotas)))
    tv = THOT.exact_hotness(TCfg(n_tenants=T), L, 64).step(THOT.HotCtx(
        hstate=None, **{k: T_(v) for k, v in ctx.items()}, t=t, rows=None,
        strategy=ts))
    got = (tv.hot, tv.demand_t, tv.demote(T_(fast), T_(quotas)),
           tv.promo_cand(T_(tier), T_(fast)).select(T_(quotas)),
           tv.demote_global(T_(fast), torch.tensor(300)).mask)
    eq(got[0], want[0], "hot")
    eq(got[1], want[1], "demand")
    for name, a, b in (("demote", got[2], want[2]),
                       ("promote", got[3], want[3])):
        for f in SEL_FIELDS:
            eq(getattr(a, f), getattr(b, f), f"{name}.{f}")
    eq(got[4], want[4], "global")
    # eager torch (two roundings) disagrees with the jitted reference
    eager = torch.where(T_(alive), 0.85 * T_(prev) + T_(acc), 0.0)
    assert not np.array_equal(eager.numpy(), want[0])


# ---------------------------------------------------------- thrash table ----
def _table(rng, slots=64):
    page = np.where(rng.random(slots) < 0.5, rng.integers(0, 4096, slots), -1
                    ).astype(np.int32)
    tick = rng.integers(0, 40, slots).astype(np.int32)
    return JTable(jnp.asarray(page), jnp.asarray(tick)), \
        TTable(T_(page), T_(tick))


@pytest.mark.parametrize("seed", range(4))
def test_thrash_table_same_tick_collision_last_lane_wins(seed):
    """A [T, k] promoted stream whose pages collide on table slots: the
    highest row-major lane wins, as in the reference's CPU scatter."""
    rng = np.random.default_rng(seed)
    jt, tt = _table(rng, slots=64)
    pages = rng.integers(0, 4096, (8, 32)).astype(np.int32)   # 256 >> 64
    take = rng.random((8, 32)) < 0.7
    got = TP.thrash_record_promotions(tt, T_(pages), T_(take), 41)
    want = JP.thrash_record_promotions(jt, jnp.asarray(pages),
                                       jnp.asarray(take), jnp.asarray(41))
    eq(got.page, want.page, "page")
    eq(got.tick, want.tick, "tick")
    flat_p, flat_m = pages.reshape(-1), take.reshape(-1)
    for slot in range(64):
        lanes = np.nonzero(flat_m & (flat_p % 64 == slot))[0]
        if lanes.size:
            assert int(got.page[slot]) == flat_p[lanes[-1]]
    # hits and per-tenant counts over a demoted stream
    owners = np.repeat(np.arange(8, dtype=np.int32), 32).reshape(8, 32)
    eq(TP.thrash_hits(got, T_(pages), T_(take), 45, TCfg()),
       JP.thrash_hits(want, jnp.asarray(pages), jnp.asarray(take),
                      jnp.asarray(45), JCfg()), "hits")
    eq(TP.thrash_check_demotions(got, T_(pages), T_(take), T_(owners), 45,
                                 TCfg(), 8),
       JP.thrash_check_demotions(want, jnp.asarray(pages), jnp.asarray(take),
                                 jnp.asarray(owners), jnp.asarray(45),
                                 JCfg(), 8), "check")


@pytest.mark.parametrize("seed", range(4))
def test_thrash_controller_matches_reference(seed):
    rng = np.random.default_rng(seed)
    T, L = 6, 60
    owner = np.repeat(np.arange(T, dtype=np.int32), L // T)
    cfg_j = JCfg(n_tenants=T, thrash_table_slots=16,
                 enable_thrash_mitigation=bool(seed % 2))
    js = j_init_state(cfg_j, L, owner=owner)
    js = js._replace(
        counters=js.counters._replace(thrash_events=jnp.asarray(
            rng.integers(0, 100, T).astype(np.int32))),
        thrash_prev=jnp.asarray(rng.integers(0, 50, T).astype(np.int32)),
        usage_prev=jnp.asarray(rng.integers(0, 30, T).astype(np.int32)),
        freed_since=jnp.asarray(rng.integers(0, 3, T).astype(np.int32)),
        promo_scale=jnp.asarray(rng.choice([1 / 64, 0.25, 1.0], T
                                           ).astype(np.float32)),
        mitigated_prev=jnp.asarray(rng.random(T) < 0.5))
    ts = convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                  device="cpu")
    usage = rng.integers(0, 30, T).astype(np.int32)
    cfg_t = TCfg(**{f: getattr(cfg_j, f) for f in TCfg.__dataclass_fields__})
    a = TP.thrash_controller(ts, T_(usage), cfg_t)
    b = JP.thrash_controller(js, jnp.asarray(usage), cfg_j)
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "table":
            eq(x.page, y.page, f)
            eq(x.tick, y.tick, f)
        else:
            eq(x, y, f)


# ------------------------------------------------------------------ stats ----
def test_residency_bucket_is_exact_log2():
    """The port's bucket is floor(log2(age)) in exact integer arithmetic; it
    matches the reference wherever the reference's f32 log2 is exact (every
    age below 8192 ticks, far beyond any run here)."""
    ages = np.arange(-3, 1 << 16, dtype=np.int32)
    got = TOS.residency_bucket(T_(ages), 64).numpy()
    a = np.maximum(ages, 1).astype(np.int64)
    exact = np.array([int(v).bit_length() - 1 for v in a])
    eq(got, exact)
    small = ages < 8192
    eq(got[small], np.asarray(JOS.residency_bucket(jnp.asarray(ages[small]),
                                                   64)))


@pytest.mark.parametrize("seed", range(4))
def test_stats_updates_match_reference(seed):
    rng = np.random.default_rng(seed)
    T, L, K = 5, 80, 16
    js = JOS.init_stats(T, (L,))
    fs = np.where(rng.random(L) < 0.5, rng.integers(0, 30, L), -1
                  ).astype(np.int32)
    js = js._replace(fast_since=jnp.asarray(fs),
                     resid_hist=jnp.asarray(rng.integers(0, 9, (T, 16)
                                                         ).astype(np.int32)))
    ts = TOS.TierStats(*(T_(getattr(js, f)) for f in TOS.TierStats._fields))
    owner = np.repeat(np.arange(T, dtype=np.int32), L // T)
    t = 37
    exited = rng.random(L) < 0.3
    j1 = JOS.record_fast_exits(js, jnp.asarray(exited), jnp.asarray(owner),
                               jnp.asarray(t))
    t1 = TOS.record_fast_exits(ts, T_(exited), T_(owner), t)
    pages = np.where(rng.random((T, K)) < 0.6,
                     rng.integers(0, L, (T, K)), L).astype(np.int32)
    pages[:, :] = np.where(pages < L, pages, L)
    take = pages < L
    # distinct taken pages, as a selection's compact stream has
    flat = pages.reshape(-1)
    dup = np.zeros(flat.shape, bool)
    seen = set()
    for i, p in enumerate(flat):
        dup[i] = p in seen
        seen.add(int(p))
    take &= ~dup.reshape(T, K)
    tenants = np.repeat(np.arange(T, dtype=np.int32), K).reshape(T, K)
    j2 = JOS.record_fast_exits_at(j1, jnp.asarray(pages), jnp.asarray(take),
                                  jnp.asarray(tenants), jnp.asarray(t))
    t2 = TOS.record_fast_exits_at(t1, T_(pages), T_(take), T_(tenants), t)
    entered = rng.random(L) < 0.2
    j3 = JOS.record_fast_entries(j2, jnp.asarray(entered), jnp.asarray(t))
    t3 = TOS.record_fast_entries(t2, T_(entered), t)
    kw = {k: rng.integers(0, 50, T).astype(np.int32)
          for k in ("promo_attempts", "promo_success", "demo_attempts",
                    "demo_success", "thrash_new")}
    thr, bp = rng.random(T) < 0.5, rng.random(T) < 0.5
    # jitted, as in the tick: XLA then fuses the windowed-rate multiply-adds
    j_update = jax.jit(lambda s, kw: JOS.update_tick(s, **kw))
    for _ in range(3):
        j3 = j_update(j3, {**{k: jnp.asarray(v) for k, v in kw.items()},
                           "contended": jnp.asarray(True),
                           "throttled": jnp.asarray(thr),
                           "below_protection": jnp.asarray(bp)})
        t3 = TOS.update_tick(t3, **{k: T_(v) for k, v in kw.items()},
                             contended=torch.tensor(True),
                             throttled=T_(thr), below_protection=T_(bp))
    for f in TOS.TierStats._fields:
        eq(getattr(t3, f), getattr(j3, f), f)
    je, te = JOS.stats_export(j3), TOS.stats_export(t3)
    assert sorted(je) == sorted(te)
    for k in je:
        eq(te[k], je[k], k)
    js_, ts_ = JOS.stats_summary(j3), TOS.stats_summary(t3)
    assert sorted(js_) == sorted(ts_)
    for k in js_:
        eq(ts_[k], js_[k], k)


# ------------------------------------------------------------------ trace ----
@pytest.mark.parametrize("seed", range(6))
def test_ring_record_and_decode_match_reference(seed):
    rng = np.random.default_rng(seed)
    C = int(rng.choice([4, 16]))
    n = int(rng.choice([3, 24]))                 # 24 > C: one-call overflow
    jr, tr = JOT.init_ring(C), TOT.init_ring(C, device="cpu")
    head0 = 2**31 - 30 if seed % 2 else 0
    jr = jr._replace(head=jnp.asarray(np.int32(head0)))
    tr = tr._replace(head=torch.tensor(head0, dtype=torch.int32))
    for t in range(4):
        mask = rng.random((2, n)) < 0.6
        pages = rng.integers(0, 500, (2, n)).astype(np.int32)
        ten = np.repeat(np.arange(2, dtype=np.int32), n).reshape(2, n)
        hot = rng.standard_normal((2, n)).astype(np.float32)
        jr = JOT.ring_record(jr, jnp.asarray(mask), jnp.asarray(pages),
                             jnp.asarray(ten), jnp.asarray(hot), t % 2,
                             jnp.asarray(np.int32(t)))
        tr = TOT.ring_record(tr, T_(mask), T_(pages), T_(ten), T_(hot),
                             t % 2, t)
        eq(tr.data, jr.data, "data")
        eq(tr.head, jr.head, "head")
    if head0 == 0:
        (je, jd), (te, td) = JOT.decode_ring(jr), TOT.decode_ring(tr)
        assert jd == td
        np.testing.assert_array_equal(te, je)
        assert JOT.ring_summary(jr) == TOT.ring_summary(tr)


# -------------------------------------------------------------- select ----
@pytest.mark.parametrize("impl_t,impl_j", [("batched", "batched"),
                                           ("ref", "pallas_ref")])
@pytest.mark.parametrize("seed", range(5))
def test_static_strategies_match_reference(seed, impl_t, impl_j):
    rng = np.random.default_rng(seed)
    T = int(rng.choice([1, 3, 6]))
    counts = rng.choice([4, 17, 29], T)
    owner = np.repeat(np.arange(T), counts).astype(np.int32)
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
    for f in ("mask", "pages", "take", "counts"):
        eq(getattr(a, f), getattr(b, f), f)
    xi = rng.integers(-5, 5, L).astype(np.int32)
    eq(ts.by_tenant(T_(xi), T_(owner)),
       js.by_tenant(jnp.asarray(xi), jnp.asarray(owner)), "by_tenant int")
    xf = (rng.random(L) * 4).astype(np.float32)
    np.testing.assert_allclose(
        ts.by_tenant(T_(xf), T_(owner)).numpy(),
        np.asarray(js.by_tenant(jnp.asarray(xf), jnp.asarray(owner))),
        rtol=1e-6, atol=1e-5)      # f32 cumsum association differs
    new = rng.random(L) < 0.4
    ra = ts.alloc_ranks(T_(new), T_(owner)).numpy()
    rb = np.asarray(js.alloc_ranks(jnp.asarray(new), jnp.asarray(owner)))
    eq(ra[new], rb[new], "alloc ranks")
    if ts.alloc_stats is not None:
        ranks, cnt = ts.alloc_stats(T_(new), T_(owner))
        eq(ranks.numpy()[new], rb[new], "alloc_stats ranks")
        eq(cnt, js.by_tenant(jnp.asarray(new.astype(np.int32)),
                             jnp.asarray(owner)), "alloc_stats counts")


@pytest.mark.parametrize("seed", range(3))
def test_select_global_and_masked_rank_match_reference(seed):
    rng = np.random.default_rng(seed)
    L = 300
    score = rng.integers(-4, 4, L).astype(np.float32)
    mask = rng.random(L) < 0.6
    for quota in (0, 7, 250):
        eq(TSEL.select_global(T_(score), T_(mask), torch.tensor(quota), 64),
           JSEL.select_global(jnp.asarray(score), jnp.asarray(mask),
                              jnp.asarray(quota), 64), f"quota {quota}")
    eq(TSEL.masked_rank(T_(mask)), JSEL.masked_rank(jnp.asarray(mask)))


def test_non_contiguous_owner_is_not_ported_yet():
    owner = np.array([0, 1, 0, 1], np.int32)
    with pytest.raises(NotImplementedError):
        TSEL.static_strategy(owner, 2, 4, impl="batched", device="cpu")
    with pytest.raises(NotImplementedError):
        TSEL.static_strategy(owner, 2, 4, impl="ref", device="cpu")


# ------------------------------------------------------ one tick at a time ----
def _small():
    kw = dict(n_tenants=3, n_fast_pages=256, n_slow_pages=256,
              lower_protection=(96, 96, 0), upper_bound=(0, 120, 0))
    tenants = [microbenchmark(150), microbenchmark(140, arrival=10),
               ci_like(120, phase_len=20)]
    return kw, tenants


@functools.lru_cache(maxsize=None)
def _jax_run(mode: str, n: int):
    """Reference state after n ticks, and its state/outputs after n + 1."""
    kw, tenants = _small()
    owner, acc, alive = build_trace(tenants, n + 1)
    cfg = JCfg(**kw)
    s_n, _ = j_run_engine(cfg, owner, acc[:n], alive[:n], mode=mode,
                          k_max=64, impl="pallas_ref")
    s_n1, outs = j_run_engine(cfg, owner, acc, alive, mode=mode, k_max=64,
                              impl="pallas_ref")
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return owner, acc, alive, host(s_n), host(s_n1), host(outs)


@pytest.mark.parametrize("impl", ["ref", "batched"])
@pytest.mark.parametrize("mode,n", [("equilibria", 9), ("equilibria", 24),
                                    ("tpp", 14), ("memtis", 9),
                                    ("static", 4)])
def test_one_tick_from_reference_state(mode, n, impl):
    """Hand the reference's state after n ticks to the port, run one port
    tick, and compare with the reference's tick n + 1 (n + 1 a controller
    tick for n = 9, 14, 24)."""
    owner, acc, alive, s_n, s_n1, outs = _jax_run(mode, n)
    kw, _ = _small()
    tick = t_make_tick(TCfg(**kw), owner, mode, k_max=64, impl=impl,
                       device="cpu")
    state = convert.state_from_numpy(s_n, device="cpu")
    new, out = tick(state, (T_(acc[n]), T_(alive[n])))
    for f in out._fields:
        x, y = getattr(out, f).numpy(), getattr(outs, f)[n]
        if f in ("throughput", "latency"):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-4,
                                       err_msg=f)
        else:
            eq(x, y, f)
    got = convert.state_to_numpy(new)
    for f, v in got.items():
        ref = getattr(s_n1, f)
        if isinstance(v, dict):
            for g, w in v.items():
                eq(w, getattr(ref, g), f"{f}.{g}")
        elif v is not None:
            eq(v, ref, f)


def test_convert_round_trip():
    _, _, _, s_n, _, _ = _jax_run("equilibria", 9)
    got = convert.state_to_numpy(convert.state_from_numpy(s_n, device="cpu"))
    for f, v in got.items():
        ref = getattr(s_n, f)
        if isinstance(v, dict):
            for g, w in v.items():
                eq(w, getattr(ref, g), f"{f}.{g}")
                assert w.dtype == np.asarray(getattr(ref, g)).dtype
        elif v is None:
            assert ref is None
        else:
            eq(v, ref, f)


def test_tier_stat_and_report_match_reference():
    """The cgroup ``tier_stat`` export and its text report of a mid-run
    state, including the int32 byte counts that wrap."""
    from repro.core.state import tier_stat as j_tier_stat
    from repro_torch.core.state import tier_stat as t_tier_stat
    _, _, _, s_n, _, _ = _jax_run("equilibria", 24)
    owner = np.asarray(s_n.owner)
    onehot = (owner[None, :] == np.arange(3)[:, None]).astype(np.int32)
    want = j_tier_stat(jax.tree_util.tree_map(jnp.asarray, s_n),
                       jnp.asarray(onehot))
    state = convert.state_from_numpy(s_n, device="cpu")
    got = t_tier_stat(state, T_(onehot))
    assert sorted(got) == sorted(want)
    for k in want:
        eq(got[k], want[k], k)
    js, ts = JOS.stats_summary(s_n.stats), TOS.stats_summary(state.stats)
    for tenant in range(3):
        assert TOS.format_tier_stat(got, ts, tenant) == \
            JOS.format_tier_stat(want, js, tenant)
