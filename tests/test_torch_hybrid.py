"""The port's hybrid family (zamba2-style: Mamba2 backbone plus one
weight-shared attention block) on the serving path, held against the JAX
reference on the CPU at the smoke config in float32.

Weights come from the reference's ``init_params`` and cross over through
``convert.params_from_numpy`` (the ``shared`` block included); tokens are
drawn from numpy seeds; the reference's serve step runs jitted. Integer KV
cache state is compared bitwise after every step, floats (hotness, pools,
the Mamba2 state) within atol/rtol 1e-4 and logits within atol 1e-3
(float32 sums taken in another order), as in ``test_torch_serve.py``.

The smoke config has 4 Mamba2 layers with the shared block before layers 0
and 2: two applications, but ``kv_layer_count`` is the reference's
``4 // 2 + 1 = 3`` and the serve step divides the page masses by 3, as the
reference does; dividing by the application count would put every hotness
value 1.5x off and fail the float comparison.
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
from repro.memtier import kvcache as JKC
from repro.models import ssm as JS
from repro.models.params import init_params as j_init_params
from repro.models.transformer import model_specs as j_specs
from repro.serve.decode import build_serve_step as j_build
from repro.serve.decode import init_serve_state as j_init
from repro_torch import convert
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.launch import serve as t_launch
from repro_torch.memtier import kvcache as TKC
from repro_torch.models import transformer as TF
from repro_torch.serve.decode import build_serve_step as t_build
from repro_torch.serve.decode import init_serve_state as t_init
from test_torch_serve import FAIR, TIGHT, compare_cache

CPU = "cpu"
ARCH = "zamba2_7b"
B, STEPS = 8, 24
CONFIGS = {"fair": FAIR, "tight": TIGHT}


def cfgs():
    return (dataclasses.replace(j_smoke(ARCH), dtype="float32"),
            dataclasses.replace(t_smoke(ARCH), dtype="float32"))


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
    """The reference's hybrid decode of ``_tokens()``: per-step logits and
    host copies of the KV cache and the Mamba2 state after every step."""
    cfg_j, _ = cfgs()
    params, _ = _weights()
    tcfg = JCfg(**CONFIGS[config])
    step = jax.jit(j_build(cfg_j, tcfg, B, STEPS, mode=mode))
    state = j_init(cfg_j, tcfg, B, STEPS)
    toks = _tokens()
    logits, caches, mambas = [], [], []
    for i in range(STEPS):
        lg, state = step(params, state, jnp.asarray(toks[:, i:i + 1]))
        logits.append(np.asarray(lg))
        caches.append(jax.tree_util.tree_map(np.asarray, state["kv"]))
        mambas.append(jax.tree_util.tree_map(np.asarray, state["mamba"]))
    return logits, caches, mambas


def test_kv_layer_count_is_the_references():
    cfg_j, cfg_t = cfgs()
    assert TKC.kv_layer_count(cfg_t) == JKC.kv_layer_count(cfg_j) == 3
    applications = sum(i % cfg_t.hybrid_attn_every == 0
                       for i in range(cfg_t.num_layers))
    assert applications == 2
    full = t_config(ARCH)
    assert TKC.kv_layer_count(full) == 14
    assert TKC.cache_dims(full, 256, 16) == (16, 16, 16)


def test_init_serve_state_matches_reference_shapes():
    cfg_j, cfg_t = cfgs()
    tcfg = TIGHT
    want = j_init(cfg_j, JCfg(**tcfg), B, STEPS)
    got = t_init(cfg_t, TCfg(**tcfg), B, STEPS, device=CPU)
    for f in ("fast_k", "slow_k", "fast_page", "page_tier"):
        assert tuple(getattr(got["kv"], f).shape) == \
            getattr(want["kv"], f).shape, f
    for f in JS.MambaCache._fields:
        g, w = getattr(got["mamba"], f), getattr(want["mamba"], f)
        assert tuple(g.shape) == w.shape, f
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), f


@pytest.mark.parametrize("config,mode", [("fair", "equilibria"),
                                         ("tight", "equilibria"),
                                         ("tight", "tpp"),
                                         ("tight", "static")])
def test_hybrid_serve_step_matches_reference(config, mode):
    """``build_serve_step`` for the hybrid over 24 steps, B = 8, 2 tenants,
    the same token matrix on both sides: integer KV cache state bitwise
    after every step, hotness and pools within 1e-4, the Mamba2 state
    within 1e-4, logits within atol 1e-3."""
    logits, caches, mambas = _jax_run(config, mode)
    _, cfg_t = cfgs()
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
            got_m = convert.mamba_cache_to_numpy(state["mamba"])
            for f in JS.MambaCache._fields:
                np.testing.assert_allclose(
                    got_m[f], np.asarray(getattr(mambas[i], f)), atol=1e-4,
                    rtol=1e-4, err_msg=f"step {i}: mamba.{f}")
    kv = state["kv"]
    assert kv.t == STEPS and int(kv.seq_len[0]) == STEPS
    assert int(kv.counters.allocations.sum()) == \
        B * (STEPS // tcfg.page_tokens)
    if config == "tight" and mode == "equilibria":
        assert int(kv.counters.promotions.sum()
                   + kv.counters.demotions.sum()) > 0
    # the spare third KV layer is never written
    assert not bool(kv.fast_k[2].any()) and not bool(kv.slow_k[2].any())


def test_hybrid_decode_matches_forward_with_migrations():
    """The port's tiered hybrid decode equals its full-sequence forward (K7
    and K8 ops) while pages sit in, and move between, both tiers
    (tests/test_serve.py:34)."""
    _, cfg_t = cfgs()
    _, model = _weights()
    tcfg = TCfg(**TIGHT)
    batch = B
    toks = torch.as_tensor(_tokens(batch=batch, seed=7))
    step = t_build(cfg_t, tcfg, batch, STEPS, device=CPU)
    state = t_init(cfg_t, tcfg, batch, STEPS, device=CPU)
    outs = []
    with torch.no_grad():
        for i in range(STEPS):
            lg, state = step(model, state, toks[:, i:i + 1])
            outs.append(lg[:, 0])
        ref = TF.hybrid_forward(model, toks)
    err = float((torch.stack(outs, dim=1) - ref).abs().max())
    assert err < 1e-3, err
    kv = state["kv"]
    assert int((kv.slow_page >= 0).sum()) > 0
    assert int(kv.counters.promotions.sum() + kv.counters.demotions.sum()) > 0


def test_hybrid_params_round_trip():
    """Reference tree -> ``HybridLM`` -> tree, every leaf (``shared``
    included) exact; the port's own init draws the same names and the
    reference's rules."""
    params, model = _weights()
    host = jax.tree_util.tree_map(np.asarray, params)
    flat = {".".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(host)[0]}
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, v in flat.items():
        np.testing.assert_array_equal(got[name].numpy(), v, err_msg=name)
    own = TF.HybridLM(cfgs()[1], seed=3, device=CPU)
    assert sorted(n for n, _ in own.named_parameters()) == sorted(flat)
    cfg = cfgs()[1]
    heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    assert torch.equal(own.layers["A_log"],
                       torch.zeros(cfg.num_layers, heads))
    assert torch.equal(own.layers["D"], torch.ones_like(own.layers["D"]))
    assert abs(float(own.layers["wdt"].std()) - 0.02) < 0.005
    assert abs(float(own.shared["out_proj"].std()) - 0.02) < 0.005


def test_mamba_cache_round_trips_bf16():
    """A reference Mamba2 decode state in the default bf16 (conv buffers as
    ml_dtypes arrays, h in float32) converts to the port's and back."""
    cfg_j = j_smoke(ARCH)
    state = j_init(cfg_j, JCfg(**TIGHT), 2, STEPS)
    rng = np.random.default_rng(6)
    mc = state["mamba"]
    mc = mc._replace(
        h=jnp.asarray(rng.standard_normal(mc.h.shape), jnp.float32),
        conv_x=jnp.asarray(rng.standard_normal(mc.conv_x.shape),
                           jnp.bfloat16))
    host = jax.tree_util.tree_map(np.asarray, mc)
    got = convert.mamba_cache_from_numpy(host, device=CPU)
    assert got.conv_x.dtype == torch.bfloat16 and got.h.dtype == torch.float32
    back = convert.mamba_cache_to_numpy(got)
    for f in JS.MambaCache._fields:
        np.testing.assert_array_equal(
            back[f], np.asarray(getattr(host, f)).astype(np.float32), f)


def test_hybrid_serve_cli_runs_on_cpu(capsys):
    t_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                   "--tenants", "2", "--batch", "4", "--steps", "12",
                   "--bound", "2"])
    out = capsys.readouterr().out
    assert "arch=zamba2-smoke" in out and "decoded 12 tokens x 4 seqs" in out
    assert out.count("pgpromote ") == 2 and "migration trace" in out


def test_full_load_of_zamba2_binds_the_budget():
    from repro_torch.configs import get_serve_load
    from repro_torch.serve.decode import fast_budget_pages
    cfg = t_config(ARCH)
    batch, steps = get_serve_load(ARCH)
    tcfg = t_launch.full_load(cfg, batch, steps)
    assert (batch, steps) == (32, 256)
    assert fast_budget_pages(cfg, tcfg, batch, steps) == 384
    assert tcfg.lower_protection == (80, 64, 32, 0)
    assert tcfg.upper_bound == (0, 112, 96, 80)
    llama = t_config("llama32_1b")
    tl = t_launch.full_load(llama, *get_serve_load("llama32_1b"))
    assert tl.lower_protection == (320, 256, 128, 0)
    assert tl.upper_bound == (0, 448, 384, 320)
