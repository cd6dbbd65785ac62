"""The port's architecture registry and the three remaining dense configs
(codeqwen1.5-7b; h2o-danube-3-4b, sliding window; qwen3-32b, qk-norm) held
against the JAX reference on the CPU.

Every config copy equals the reference's ``CONFIG`` and ``smoke_config()``
field for field. At the smoke configs in float32, weights come from the
reference's ``init_params`` through ``convert.params_from_numpy``, tokens
from numpy seeds, and the reference runs jitted. The serve step is compared
after every step in three modes: integer KV cache state bitwise; float
state (hotness, pools) within rtol/atol 1e-4 and logits within atol 1e-3,
the whole-decode bounds of ``test_torch_serve.py`` (float32 sums in another
order, through two layers of attention whose softmax is peaked:
``compare_cache``'s rtol 1e-5 / atol 1e-6 holds for the pieces, not for
whole decodes, whose second-layer K/V pools are far from order 1). The
windowed config decodes 48 steps, past its window of 32. The prefill is
held against the reference's prefill step (its full forward's last
position) within 1e-4 of max |logit| (``test_torch_prefill.py``'s bound)
at S = 64, past the window (the reference's banded attention needs S to
be a multiple of it).

``serve_matches_reference`` and ``prefill_matches_reference`` are shared
with ``test_torch_moe.py`` and ``test_torch_ssm.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs import reduced_depth_config as j_reduced
from repro.configs.base import TieringConfig as JCfg
from repro.configs.base import TrainConfig
from repro.models.params import init_params as j_init_params
from repro.models.transformer import model_specs as j_specs
from repro.serve.decode import build_serve_step as j_build
from repro.serve.decode import init_serve_state as j_init
from repro.train.step import make_prefill_step as j_prefill
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_serve_load
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import reduced_depth_config
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.launch import serve as t_launch
from repro_torch.memtier import kvcache as TKC
from repro_torch.models import transformer as TF
from repro_torch.serve.decode import build_serve_step as t_build
from repro_torch.serve.decode import init_serve_state as t_init
from repro_torch.train.step import make_prefill_step as t_prefill
from test_torch_serve import TIGHT, compare_cache

CPU = "cpu"
B = 8
MODES = ("equilibria", "tpp", "static")
DENSE = ("codeqwen15_7b", "h2o_danube_3_4b", "qwen3_32b")
# whole decodes (test_torch_serve.py): float state (rtol, atol), logits atol
F32_TOL = (1e-4, 1e-4)
LOGIT_ATOL = 1e-3
FWD_RTOL = 1e-4      # the prefill, relative to max |logit|


def steps_of(cfg) -> int:
    """Decode steps of a smoke config's serve comparison: past the window
    of a windowed config (32 at the smoke widths)."""
    return 48 if cfg.sliding_window is not None else 24


@functools.lru_cache(maxsize=None)
def weights(arch: str):
    """(reference params, port model, float32 configs) of ``arch``'s smoke
    config."""
    cfg_j = dataclasses.replace(j_smoke(arch), dtype="float32")
    cfg_t = dataclasses.replace(t_smoke(arch), dtype="float32")
    params = j_init_params(jax.random.PRNGKey(0), j_specs(cfg_j))
    host = jax.tree_util.tree_map(np.asarray, params)
    return params, convert.params_from_numpy(host, cfg_t, device=CPU), \
        cfg_j, cfg_t


def tokens(cfg, batch, steps, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, steps)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str, mode: str):
    """The reference's decode of ``tokens``: per-step logits and host
    copies of the state after every step."""
    params, _, cfg_j, _ = weights(arch)
    steps = steps_of(cfg_j)
    tcfg = JCfg(**TIGHT)
    step = jax.jit(j_build(cfg_j, tcfg, B, steps, mode=mode))
    state = j_init(cfg_j, tcfg, B, steps)
    toks = tokens(cfg_j, B, steps)
    logits, states = [], []
    for i in range(steps):
        lg, state = step(params, state, jnp.asarray(toks[:, i:i + 1]))
        logits.append(np.asarray(lg))
        states.append(jax.tree_util.tree_map(np.asarray, state))
    return logits, states


def serve_matches_reference(arch: str, mode: str, tol=F32_TOL):
    """``build_serve_step`` of ``arch``'s smoke config against the jitted
    reference step by step on the same token matrix: integer KV state
    bitwise, float state (the Mamba2 state too) within ``tol`` (rtol,
    atol), logits within ``LOGIT_ATOL``. Returns the port's final state."""
    logits, states = _jax_run(arch, mode)
    _, model, _, cfg_t = weights(arch)
    steps = steps_of(cfg_t)
    tcfg = TCfg(**TIGHT)
    step = t_build(cfg_t, tcfg, B, steps, mode=mode, device=CPU)
    state = t_init(cfg_t, tcfg, B, steps, device=CPU)
    assert sorted(state) == sorted(states[0])
    toks = torch.as_tensor(tokens(cfg_t, B, steps))
    rtol, atol = tol
    with torch.no_grad():
        for i in range(steps):
            lg, state = step(model, state, toks[:, i:i + 1])
            np.testing.assert_allclose(lg.numpy(), logits[i], rtol=0,
                                       atol=LOGIT_ATOL,
                                       err_msg=f"step {i} logits")
            if "kv" in state:
                compare_cache(convert.cache_to_numpy(state["kv"]),
                              states[i]["kv"], rtol=rtol, atol=atol,
                              msg=f"step {i}: ")
            if "mamba" in state:
                got = convert.mamba_cache_to_numpy(state["mamba"])
                for f, v in got.items():
                    np.testing.assert_allclose(
                        v, np.asarray(getattr(states[i]["mamba"], f)),
                        rtol=rtol, atol=atol, err_msg=f"step {i}: mamba.{f}")
    return state


def prefill_matches_reference(arch: str):
    """``make_prefill_step`` against the reference's jitted prefill step at
    B=3, S=64 (past the smoke window of 32); ``impl="ref"`` agrees."""
    params, model, cfg_j, cfg_t = weights(arch)
    toks = tokens(cfg_j, 3, 64, seed=11)
    want = jax.jit(j_prefill(cfg_j, TrainConfig(remat_policy="none")))(
        params, {"tokens": jnp.asarray(toks)})
    got = t_prefill(cfg_t, device=CPU)(model, {"tokens": torch.as_tensor(
        toks)})
    assert got.shape == (3, cfg_t.vocab_size)
    want = np.asarray(want)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < FWD_RTOL, rel
    ref = t_prefill(cfg_t, impl="ref", device=CPU)(
        model, {"tokens": torch.as_tensor(toks)})
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# ------------------------------------------------------------ registry ----
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copy_matches_reference(arch):
    """``CONFIG`` and ``smoke_config()`` equal the reference's field for
    field (the MoE and SSM sub-configs included)."""
    for got, want in ((get_config(arch), j_config(arch)),
                      (t_smoke(arch), j_smoke(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert type(got).__name__ == type(want).__name__


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_depth_config_matches_reference(arch):
    for n in (1, 6, 8, 13):
        assert dataclasses.asdict(reduced_depth_config(arch, n)) == \
            dataclasses.asdict(j_reduced(arch, n))


def test_registry_covers_the_decoder_families():
    """The port's registry is the reference's, in its order, and the model
    router holds all six families."""
    from repro.configs import ARCH_IDS as J_IDS
    assert ARCH_IDS == J_IDS
    assert get_config("h2o-danube-3-4b") is get_config("h2o_danube_3_4b")
    assert get_config("mixtral_8x22b").moe.capacity_factor == 1.25
    loads = {a: get_serve_load(a) for a in ARCH_IDS}
    assert loads == {"mixtral_8x22b": (16, 64),
                     "granite_moe_3b_a800m": (64, 256),
                     "qwen3_32b": (32, 64), "codeqwen15_7b": (32, 64),
                     "h2o_danube_3_4b": (32, 64), "llama32_1b": (64, 512),
                     "mamba2_130m": (64, 256), "whisper_tiny": (64, 256),
                     "llama32_vision_90b": (16, 64), "zamba2_7b": (32, 256)}
    assert set(TF.FAMILIES) == {"dense", "moe", "ssm", "hybrid", "encdec",
                                "vlm"}
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("whisper_large")


def test_kv_layer_count_is_the_references():
    from repro.memtier import kvcache as JKC
    for arch in ARCH_IDS:
        assert TKC.kv_layer_count(get_config(arch)) == \
            JKC.kv_layer_count(j_config(arch)), arch
    assert TKC.kv_layer_count(get_config("mamba2_130m")) == 0


def test_full_load_of_the_new_configs():
    """``full_load``: granite's and whisper's budgets bind (768 of 1,024
    logical pages); the windowed configs' logical pages cover the window;
    the ssm family has no budget to share."""
    from repro_torch.serve.decode import fast_budget_pages
    cases = {"granite_moe_3b_a800m": (768, (160, 128, 64, 0),
                                      (0, 224, 192, 160)),
             "mixtral_8x22b": (3264, (680, 544, 272, 0),
                               (0, 952, 816, 680)),
             "qwen3_32b": (384, (80, 64, 32, 0), (0, 112, 96, 80)),
             "whisper_tiny": (768, (160, 128, 64, 0), (0, 224, 192, 160)),
             "llama32_vision_90b": (192, (40, 32, 16, 0), (0, 56, 48, 40))}
    for arch, (budget, prot, bound) in cases.items():
        cfg = get_config(arch)
        batch, steps = get_serve_load(arch)
        tcfg = t_launch.full_load(cfg, batch, steps)
        assert fast_budget_pages(cfg, tcfg, batch, steps) == budget, arch
        assert (tcfg.lower_protection, tcfg.upper_bound) == (prot, bound)
    ssm = t_launch.full_load(get_config("mamba2_130m"), 64, 256)
    assert ssm.lower_protection == () and ssm.upper_bound == ()


# ------------------------------------------------------- dense configs ----
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DENSE)
def test_dense_serve_step_matches_reference(arch, mode):
    state = serve_matches_reference(arch, mode)
    kv = state["kv"]
    steps = steps_of(weights(arch)[3])
    assert kv.t == steps and int(kv.seq_len[0]) == steps
    if mode != "static":
        assert int(kv.counters.promotions.sum()
                   + kv.counters.demotions.sum()) > 0


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_matches_reference(arch):
    prefill_matches_reference(arch)


def test_windowed_decode_matches_forward_past_the_window():
    """h2o-danube's smoke model (window 32): 48 decode steps equal the
    full-sequence forward (K7's plain version, windowed) at every
    position, while pages sit in both tiers."""
    _, model, _, cfg_t = weights("h2o_danube_3_4b")
    tcfg = TCfg(**TIGHT)
    steps = steps_of(cfg_t)
    toks = torch.as_tensor(tokens(cfg_t, 4, steps, seed=7))
    step = t_build(cfg_t, tcfg, 4, steps, device=CPU)
    state = t_init(cfg_t, tcfg, 4, steps, device=CPU)
    outs = []
    with torch.no_grad():
        for i in range(steps):
            lg, state = step(model, state, toks[:, i:i + 1])
            outs.append(lg[:, 0])
        ref = TF.lm_forward(model, toks)
    err = float((torch.stack(outs, dim=1) - ref).abs().max())
    assert err < 1e-3, err
    assert int((state["kv"].slow_page >= 0).sum()) > 0
