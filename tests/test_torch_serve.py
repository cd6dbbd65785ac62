"""The port's tiered paged-KV serving path (dense family) held against the
JAX reference on the CPU, at the smoke llama config in float32.

Weights come from the reference's ``init_params`` and cross over through
``convert.params_from_numpy``; tokens and masses are drawn from numpy
seeds; reference functions that hold float arithmetic run jitted, as in
the reference's serve step. Integer cache state (page tables, slot pages,
counters, thrash table, ring columns, stats) is compared bitwise; floats
within rtol 1e-5 (the pieces) or, over whole decodes, atol 1e-3 on logits
and 1e-4 on pools and hotness (float32 sums taken in another order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import TieringConfig as JCfg
from repro.core import select as JSEL
from repro.core.state import make_policy as j_make_policy
from repro.memtier import kvcache as JKC
from repro.memtier.tiering import equilibria_kv_step as j_kv_step
from repro.models.params import init_params as j_init_params
from repro.models.transformer import model_forward as j_forward
from repro.models.transformer import model_specs as j_specs
from repro.serve.decode import build_serve_step as j_build
from repro.serve.decode import init_serve_state as j_init
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.core import select as TSEL
from repro_torch.core.state import make_policy as t_make_policy
from repro_torch.launch import serve as t_launch
from repro_torch.memtier import kvcache as TKC
from repro_torch.memtier.tiering import equilibria_kv_step as t_kv_step
from repro_torch.models import transformer as TF
from repro_torch.models.transformer import DenseLM
from repro_torch.serve.decode import build_serve_step as t_build
from repro_torch.serve.decode import init_serve_state as t_init

CPU = "cpu"
B, STEPS = 8, 24
# tests/test_serve.py's fairness-counter config (no bound: no migrations)
FAIR = dict(n_tenants=2, page_tokens=4, thrash_table_slots=64,
            lower_protection=(12, 12), upper_bound=(0, 0))
# tests/test_serve.py's TCFG: bounds of 3 pages force slow pages and moves
TIGHT = dict(n_tenants=2, page_tokens=4, thrash_table_slots=64,
             lower_protection=(2, 2), upper_bound=(3, 3))
# one-token pages: 32 logical pages, 32 fast but 16 slow slots per sequence
# (the pools differ in size, as at full width); tenant 1 bounded
WIDE = dict(n_tenants=2, page_tokens=1, thrash_table_slots=64,
            lower_protection=(8, 8), upper_bound=(0, 40))
CONFIGS = {"fair": FAIR, "tight": TIGHT, "wide": WIDE}


def T_(x):
    return torch.as_tensor(np.array(x))


def cfgs():
    return (dataclasses.replace(j_smoke("llama32_1b"), dtype="float32"),
            dataclasses.replace(t_smoke("llama32_1b"), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _weights():
    cfg_j, cfg_t = cfgs()
    params = j_init_params(jax.random.PRNGKey(0), j_specs(cfg_j))
    host = jax.tree_util.tree_map(np.asarray, params)
    return params, convert.params_from_numpy(host, cfg_t, device=CPU)


def _tokens(steps=STEPS, batch=B, seed=0):
    vocab = cfgs()[0].vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (batch, steps)
                                                 ).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(config: str, mode: str):
    """The reference's decode of ``_tokens()``: per-step logits and host
    copies of the KV cache after every step."""
    cfg_j, _ = cfgs()
    params, _ = _weights()
    tcfg = JCfg(**CONFIGS[config])
    step = jax.jit(j_build(cfg_j, tcfg, B, STEPS, mode=mode))
    state = j_init(cfg_j, tcfg, B, STEPS)
    toks = _tokens()
    logits, caches = [], []
    for i in range(STEPS):
        lg, state = step(params, state, jnp.asarray(toks[:, i:i + 1]))
        logits.append(np.asarray(lg))
        caches.append(jax.tree_util.tree_map(np.asarray, state["kv"]))
    return logits, caches


def compare_cache(got, want, rtol=1e-5, atol=1e-6, msg=""):
    """Port cache (``cache_to_numpy`` dict) vs a reference cache with numpy
    leaves: integers bitwise, floats within tolerance; the ring's hotness
    column is float bits."""
    for f, v in got.items():
        ref = getattr(want, f)
        pairs = ({f"{f}.{g}": (w, np.asarray(getattr(ref, g)))
                  for g, w in v.items()} if isinstance(v, dict)
                 else {f: (v, np.asarray(ref))})
        for name, (a, b) in pairs.items():
            if name == "ring.data":
                np.testing.assert_array_equal(a[:, :4], b[:, :4],
                                              err_msg=msg + name)
                a, b = a[:, 4].view(np.float32), b[:, 4].view(np.float32)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                           err_msg=msg + name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=msg + name)
                assert a.dtype == b.dtype, msg + name


# ------------------------------------------------------------ pieces ----
@pytest.mark.parametrize("seed", range(4))
def test_segment_ranks_and_select_top_quota_match_reference(seed):
    rng = np.random.default_rng(seed)
    L, T = 40, 5
    owner = rng.integers(0, T, L).astype(np.int32)
    score = rng.integers(-2, 3, L).astype(np.float32)
    score[rng.random(L) < 0.3] = 0.0
    score[rng.random(L) < 0.3] = -0.0            # ties between -0.0 and 0.0
    score[rng.random(L) < 0.05] = np.inf
    active = rng.random(L) < 0.8
    quotas = rng.integers(-1, 6, T).astype(np.int32)
    seg = np.where(active, owner, T).astype(np.int32)
    np.testing.assert_array_equal(
        TSEL.segment_ranks(T_(seg), T_(-score), T).numpy(),
        np.asarray(JSEL.segment_ranks(jnp.asarray(seg), jnp.asarray(-score),
                                      T)))
    for k_cap in (2, 4, 64):
        np.testing.assert_array_equal(
            TSEL.select_top_quota(T_(score), T_(owner), T_(active),
                                  T_(quotas), T, k_cap).numpy(),
            np.asarray(JSEL.select_top_quota(
                jnp.asarray(score), jnp.asarray(owner), jnp.asarray(active),
                jnp.asarray(quotas), T, k_cap)))


def test_segment_ranks_zero_signs_tie_on_index():
    key = torch.tensor([0.0, -0.0, 0.0, -0.0])
    seg = torch.zeros(4, dtype=torch.int32)
    assert TSEL.segment_ranks(seg, key, 1).tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("n", [0, 3, 12, 17])
def test_alloc_page_for_append_matches_reference(n):
    """Allocation from the reference's cache after n steps (n = 0: empty
    cache), in the config whose bounds send pages to the slow tier."""
    _, caches = _jax_run("tight", "equilibria")
    cfg_j, cfg_t = cfgs()
    jt, tt = JCfg(**TIGHT), TCfg(**TIGHT)
    j_cache = (JKC.init_cache(cfg_j, jt, B, STEPS) if n == 0
               else jax.tree_util.tree_map(jnp.asarray, caches[n - 1]))
    budget = max(int(B * JKC.cache_dims(cfg_j, STEPS, 4)[0] * 0.75), 1)
    want, want_lp = jax.jit(
        lambda c: JKC.alloc_page_for_append(c, jt, j_make_policy(jt),
                                            budget))(j_cache)
    got, got_lp = TKC.alloc_page_for_append(
        convert.cache_from_numpy(jax.tree_util.tree_map(np.asarray, j_cache),
                                 device=CPU),
        tt, t_make_policy(tt, device=CPU), budget)
    np.testing.assert_array_equal(got_lp.numpy(), np.asarray(want_lp))
    compare_cache(convert.cache_to_numpy(got),
                  jax.tree_util.tree_map(np.asarray, want))


def test_append_token_kv_matches_reference():
    _, caches = _jax_run("tight", "equilibria")
    cfg_j, _ = cfgs()
    jt, tt = JCfg(**TIGHT), TCfg(**TIGHT)
    j_cache = jax.tree_util.tree_map(jnp.asarray, caches[6])
    budget = max(int(B * JKC.cache_dims(cfg_j, STEPS, 4)[0] * 0.75), 1)
    j_cache, lpage = JKC.alloc_page_for_append(j_cache, jt,
                                               j_make_policy(jt), budget)
    rng = np.random.default_rng(5)
    K, D = cfg_j.num_kv_heads, cfg_j.resolved_head_dim
    k_new = rng.standard_normal((B, 1, K, D)).astype(np.float32)
    v_new = rng.standard_normal((B, 1, K, D)).astype(np.float32)
    want = JKC.append_token_kv(j_cache.fast_k[0], j_cache.fast_v[0],
                               j_cache.slow_k[0], j_cache.slow_v[0], j_cache,
                               lpage, jnp.asarray(k_new), jnp.asarray(v_new))
    t_cache = convert.cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_cache), device=CPU)
    pools = (t_cache.fast_k[0], t_cache.fast_v[0], t_cache.slow_k[0],
             t_cache.slow_v[0])
    TKC.append_token_kv(*pools, t_cache, T_(lpage), T_(k_new), T_(v_new))
    for g, w in zip(pools, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the layer views were written in place
    np.testing.assert_array_equal(t_cache.fast_k[0].numpy(),
                                  np.asarray(want[0]))


@pytest.mark.parametrize("mode,n,bound,pressure,moves", [
    ("equilibria", 9, 1, False, "demotions"),     # over the upper bound
    ("equilibria", 12, 0, False, "promotions"),   # hot slow pages, room
    ("tpp", 14, 3, True, "demotions"),            # over the budget
    ("tpp", 11, 0, False, "promotions"),
    ("static", 9, 3, True, None)])
def test_equilibria_kv_step_matches_reference(mode, n, bound, pressure,
                                              moves):
    """One tiering step from the reference's cache after n steps of the
    tight decode, with seeded attention masses, under a policy that makes
    pages move (n + 1 = 10 and 15 run the controller). ``pressure`` sets
    the fast budget to the pages in use."""
    _, caches = _jax_run("tight", "equilibria")
    cfg_j, _ = cfgs()
    kw = dict(TIGHT, upper_bound=(bound, bound))
    jt, tt = JCfg(**kw), TCfg(**kw)
    start = caches[n - 1]
    j_cache = jax.tree_util.tree_map(jnp.asarray, start)
    rng = np.random.default_rng(n)
    mf = rng.random(start.fast_hot.shape).astype(np.float32) * 3
    ms = rng.random(start.slow_hot.shape).astype(np.float32) * 3
    budget = (int((start.fast_page >= 0).sum()) if pressure
              else max(int(B * JKC.cache_dims(cfg_j, STEPS, 4)[0] * 0.75), 1))
    want = jax.jit(lambda c, a, b: j_kv_step(c, a, b, jt, j_make_policy(jt),
                                             budget, mode=mode))(
        j_cache, jnp.asarray(mf), jnp.asarray(ms))
    got = t_kv_step(convert.cache_from_numpy(start, device=CPU),
                    T_(mf), T_(ms), tt, t_make_policy(tt, device=CPU),
                    budget, mode=mode, impl="ref")
    want = jax.tree_util.tree_map(np.asarray, want)
    compare_cache(convert.cache_to_numpy(got), want)
    if moves is not None:
        assert (getattr(want.counters, moves).sum()
                > getattr(start.counters, moves).sum())


@pytest.mark.parametrize("window", [None, 9])
def test_token_validity_and_counters_match_reference(window):
    _, caches = _jax_run("tight", "equilibria")
    start = caches[13]
    j_cache = jax.tree_util.tree_map(jnp.asarray, start)
    t_cache = convert.cache_from_numpy(start, device=CPU)
    for g, w in zip(TKC.token_validity(t_cache, window),
                    JKC.token_validity(j_cache, window)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got, want = TKC.kv_tier_counters(t_cache), JKC.kv_tier_counters(j_cache)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cache_conversion_round_trips_bf16():
    """A reference cache in its default bf16 (numpy has no bf16: ml_dtypes
    arrays) converts to the port's cache and back; bf16 widens exactly."""
    cfg_j, _ = cfgs()
    cfg_j = dataclasses.replace(cfg_j, dtype="bfloat16")
    j_cache = JKC.init_cache(cfg_j, JCfg(**TIGHT), 2, STEPS)
    rng = np.random.default_rng(4)
    fk = rng.standard_normal(j_cache.fast_k.shape).astype(np.float32)
    j_cache = j_cache._replace(fast_k=jnp.asarray(fk, jnp.bfloat16))
    host = jax.tree_util.tree_map(np.asarray, j_cache)
    t_cache = convert.cache_from_numpy(host, device=CPU)
    assert t_cache.fast_k.dtype == torch.bfloat16 and t_cache.t == 0
    back = convert.cache_to_numpy(t_cache)
    np.testing.assert_array_equal(back["fast_k"],
                                  host.fast_k.astype(np.float32))
    compare_cache(back, host)


# ------------------------------------------------------ whole decode ----
@pytest.mark.parametrize("config,mode", [("fair", "equilibria"),
                                         ("tight", "equilibria"),
                                         ("tight", "tpp"),
                                         ("tight", "static"),
                                         ("wide", "equilibria")])
def test_serve_step_matches_reference(config, mode):
    """``build_serve_step`` over 24 steps, B = 8, 2 tenants, the same token
    matrix on both sides: integer cache state bitwise after every step,
    logits within atol 1e-3."""
    logits, caches = _jax_run(config, mode)
    cfg_j, cfg_t = cfgs()
    _, model = _weights()
    tcfg = TCfg(**CONFIGS[config])
    step = t_build(cfg_t, tcfg, B, STEPS, mode=mode, device=CPU)
    state = t_init(cfg_t, tcfg, B, STEPS, device=CPU)
    toks = torch.as_tensor(_tokens())
    with torch.no_grad():
        for i in range(STEPS):
            lg, state = step(model, state, toks[:, i:i + 1])
            np.testing.assert_allclose(lg.numpy(), logits[i], atol=1e-3,
                                       rtol=0, err_msg=f"step {i} logits")
            compare_cache(convert.cache_to_numpy(state["kv"]), caches[i],
                          rtol=1e-4, atol=1e-4, msg=f"step {i}: ")
    kv = state["kv"]
    assert kv.t == STEPS and int(kv.seq_len[0]) == STEPS
    assert int(kv.counters.allocations.sum()) == \
        B * (STEPS // tcfg.page_tokens)
    if config == "wide":     # fast slots past the slow pool's size in use
        assert int(kv.fast_page.shape[1]) > int(kv.slow_page.shape[1])
        assert int((kv.fast_page[:, kv.slow_page.shape[1]:] >= 0).sum()) > 0
        assert int((kv.slow_page >= 0).sum()) > 0
    if config == "tight" and mode != "static":
        assert int(kv.counters.promotions.sum()
                   + kv.counters.demotions.sum()) > 0


def test_lm_forward_matches_reference():
    cfg_j, _ = cfgs()
    params, model = _weights()
    toks = _tokens(steps=16, batch=2, seed=3)
    want, _ = j_forward(params, {"tokens": jnp.asarray(toks)}, cfg_j,
                        remat="none")
    with torch.no_grad():
        got = TF.lm_forward(model, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)


def test_decode_matches_forward_with_slow_pages():
    """The port's own tiered decode equals its full-sequence forward while
    pages sit in, and move between, both tiers (tests/test_serve.py:34)."""
    _, cfg_t = cfgs()
    _, model = _weights()
    tcfg = TCfg(**TIGHT)
    batch = 2
    toks = torch.as_tensor(_tokens(batch=batch, seed=7))
    step = t_build(cfg_t, tcfg, batch, STEPS, device=CPU)
    state = t_init(cfg_t, tcfg, batch, STEPS, device=CPU)
    outs = []
    with torch.no_grad():
        for i in range(STEPS):
            lg, state = step(model, state, toks[:, i:i + 1])
            outs.append(lg[:, 0])
        ref = TF.lm_forward(model, toks)
    err = float((torch.stack(outs, dim=1) - ref).abs().max())
    assert err < 1e-3, err
    kv = state["kv"]
    assert int((kv.slow_page >= 0).sum()) > 0
    assert int(kv.seq_len[0]) == STEPS


# ------------------------------------------------------ model and CLI ----
def test_dense_lm_init_follows_reference_rules():
    _, cfg_t = cfgs()
    a = DenseLM(cfg_t, seed=3, device=CPU)
    b = DenseLM(cfg_t, seed=3, device=CPU)
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    L = cfg_t.num_layers
    assert torch.equal(a.layers["ln1"], torch.ones(L, cfg_t.d_model))
    assert torch.equal(a.embed["final_norm"], torch.ones(cfg_t.d_model))
    # fan_in of a stacked spec is its first dimension, the layer count
    wg = a.layers["mlp"]["wg"]
    assert abs(float(wg.std()) - 1 / np.sqrt(L)) < 0.05
    assert abs(float(a.embed["tok"].std()) - 1.0) < 0.05
    names = {n for n, _ in a.named_parameters()}
    host = jax.tree_util.tree_map(np.asarray, _weights()[0])
    flat = {".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(host)[0]}
    assert names == flat


def test_serve_cli_runs_on_cpu(capsys):
    t_launch.main(["--smoke", "--device", "cpu", "--tenants", "2",
                   "--batch", "4", "--steps", "12", "--bound", "2"])
    out = capsys.readouterr().out
    assert "decoded 12 tokens x 4 seqs" in out
    assert out.count("pgpromote ") == 2 and "migration trace" in out
    with pytest.raises(SystemExit):
        t_launch.main(["--smoke", "--device", "cpu", "--production"])
