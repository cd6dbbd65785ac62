"""The port's moe family (granite-moe-3b-a800m, Mixtral 8x22B) held against
the JAX reference on the CPU, at the smoke configs in float32.

``moe_block`` (the prefill's grouped-gather dispatch, out and aux loss) and
``moe_block_decode`` are held against the reference's jitted functions
within rtol 1e-5 / atol 1e-5 on the scale of the output (atol 1e-5 times
its max |value|: the experts' outputs reach about 100 at the smoke widths,
whose stacked init draws std 1/sqrt(2), and an element that cancels to
near 0 keeps the float32 rounding of its terms): the port groups the
decode tokens by expert and adds the experts into their tokens one expert
after another, so only the float association of the per-expert sums
differs. Ties are forced into
the router (duplicated router columns, and a zero router under which every
probability ties), where the tie order decides which experts and which
tokens are picked: the port's stable sort takes ties to the lower index,
as ``lax.top_k`` does. The serve step (all three modes; Mixtral's window
of 32 passed by 48 decode steps), the prefill, the aux loss through
``lm_forward`` and the launcher are held as ``test_torch_configs.py``
holds the dense configs. Decode == forward is not an identity of the moe
family (``moe_block`` drops tokens over capacity, ``moe_block_decode``
drops none), so the decode is held only against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.transformer import model_forward as j_forward
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as t_launch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TF
from test_torch_configs import (MODES, prefill_matches_reference,
                                serve_matches_reference, steps_of, tokens,
                                weights)

CPU = "cpu"
ARCHS = ("granite_moe_3b_a800m", "mixtral_8x22b")
MOE_RTOL = MOE_ATOL = 1e-5
ROUTERS = ("random", "paired", "zero")


def assert_moe_close(got, want):
    """Within rtol 1e-5 and atol 1e-5 on the scale of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=MOE_RTOL,
                               atol=MOE_ATOL * max(np.abs(want).max(), 1.0))


def _moe_params(arch: str, router: str):
    """Layer 0's MoE parameters of ``arch``'s smoke model as numpy, with
    the router ``random`` (as drawn), ``paired`` (each odd expert's column a
    copy of the even one before it: exact ties between the two) or
    ``zero`` (every probability 1/E: all experts and tokens tie)."""
    params, _, cfg_j, cfg_t = weights(arch)
    p = {k: np.array(v[0]) for k, v in params["layers"]["moe"].items()}
    if router == "paired":
        p["router"][:, 1::2] = p["router"][:, 0::2]
    elif router == "zero":
        p["router"][:] = 0.0
    return p, cfg_j, cfg_t


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, router):
    p, cfg_j, cfg_t = _moe_params(arch, router)
    x = _x(cfg_j, 3, 24, seed=1)
    out, aux = jax.jit(lambda p, x: JL.moe_block(p, x, cfg_j))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got, got_aux = TL.moe_block({k: torch.as_tensor(v) for k, v in p.items()},
                                torch.as_tensor(x), cfg_t)
    assert_moe_close(got.numpy(), out)
    assert_moe_close(float(got_aux), float(aux))
    if router != "random":
        probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
        assert bool((probs[..., 0] == probs[..., 1]).all())


def test_moe_block_capacity_drops_tokens_by_index():
    """Under the zero router every token is a member of every expert and
    ties; each expert keeps the first C = max(ceil(S k / E x 1.25), 4)
    tokens, so later tokens get no expert and their output is 0."""
    arch = "granite_moe_3b_a800m"
    p, _, cfg_t = _moe_params(arch, "zero")
    m = cfg_t.moe
    s = 24
    capacity = max(int(np.ceil(s * m.top_k / m.num_experts
                               * m.capacity_factor)), 4)
    assert capacity < s
    x = torch.as_tensor(_x(cfg_t, 2, s, seed=2))
    out, _ = TL.moe_block({k: torch.as_tensor(v) for k, v in p.items()}, x,
                          cfg_t)
    assert bool((out[:, capacity:] == 0).all())
    assert bool((out[:, :capacity].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_decode_matches_reference(arch, router):
    p, cfg_j, cfg_t = _moe_params(arch, router)
    x = _x(cfg_j, 9, 1, seed=3)
    want = jax.jit(lambda p, x: JL.moe_block_decode(p, x, cfg_j))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = TL.moe_block_decode({k: torch.as_tensor(v) for k, v in p.items()},
                              torch.as_tensor(x), cfg_t)
    assert_moe_close(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serve_step_matches_reference(arch, mode):
    state = serve_matches_reference(arch, mode)
    kv = state["kv"]
    steps = steps_of(weights(arch)[3])
    assert kv.t == steps and int(kv.seq_len[0]) == steps
    if mode != "static":
        assert int(kv.counters.promotions.sum()
                   + kv.counters.demotions.sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_matches_reference(arch):
    prefill_matches_reference(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_reference(arch):
    """``lm_forward(return_aux=True)``: the logits and the aux loss summed
    over layers, against the reference's ``model_forward``."""
    params, model, cfg_j, _ = weights(arch)
    toks = tokens(cfg_j, 2, 32, seed=5)
    want, want_aux = jax.jit(lambda p, t: j_forward(
        p, {"tokens": t}, cfg_j, remat="none"))(params, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = TF.lm_forward(model, torch.as_tensor(toks),
                                 return_aux=True)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-4
    assert_moe_close(float(aux), float(want_aux))
    assert float(aux) > 0


def test_moe_params_round_trip():
    """Reference tree -> ``MoELM`` -> every leaf exact; the port's own init
    draws the same names, the router at std 0.02."""
    params, model, _, cfg_t = weights("granite_moe_3b_a800m")
    host = jax.tree_util.tree_map(np.asarray, params)
    flat = {".".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(host)[0]}
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat) and "layers.moe.wg" in got
    for name, v in flat.items():
        np.testing.assert_array_equal(got[name].numpy(), v, err_msg=name)
    own = TF.MoELM(cfg_t, seed=3, device=CPU)
    assert sorted(n for n, _ in own.named_parameters()) == sorted(flat)
    m = cfg_t.moe
    assert tuple(own.layers["moe"]["wg"].shape) == (
        cfg_t.num_layers, m.num_experts, cfg_t.d_model, m.d_ff_expert)
    assert abs(float(own.layers["moe"]["router"].std()) - 0.02) < 0.005
    with pytest.raises(ValueError, match="make_model"):
        TF.DenseLM(cfg_t, device=CPU)


def test_bf16_weights_draw_in_blocks():
    """A bfloat16 ``param_dtype`` draws its weights a block of leading rows
    at a time (Mixtral's experts do not fit one card in float32): the same
    names and shapes, the init rules' spreads, no float32 leaf."""
    cfg = dataclasses.replace(t_smoke("mixtral_8x22b"),
                              param_dtype="bfloat16")
    model = TF.make_model(cfg, seed=0, device=CPU)
    assert isinstance(model, TF.MoELM)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    wg = model.layers["moe"]["wg"].float()
    assert abs(float(wg.std()) - 1 / np.sqrt(cfg.num_layers)) < 0.05
    assert abs(float(model.embed["tok"].float().std()) - 1.0) < 0.05


def test_moe_serve_cli_runs_on_cpu(capsys):
    t_launch.main(["--arch", "granite_moe_3b_a800m", "--smoke", "--device",
                   "cpu", "--tenants", "2", "--batch", "4", "--steps", "12",
                   "--bound", "2"])
    out = capsys.readouterr().out
    assert "arch=granite-moe-smoke" in out and "decoded 12 tokens x 4" in out
    assert out.count("pgpromote ") == 2 and "migration trace" in out


def test_mixtral_full_width_specs():
    """Mixtral 8x22B at full width: 141B parameters at its 56 layers, 20.4B
    at the 8 the card runs (``reduced_depth_config``)."""
    from repro_torch.configs import reduced_depth_config
    from repro_torch.models.params import ParamSpec
    cfg = t_config("mixtral_8x22b")

    def count(c):
        n = 0
        stack = [TF.model_specs(c)]
        while stack:
            for v in stack.pop().values():
                if isinstance(v, ParamSpec):
                    n += int(np.prod(v.shape))
                else:
                    stack.append(v)
        return n

    assert 140e9 < count(cfg) < 142e9
    assert 20.2e9 < count(reduced_depth_config("mixtral_8x22b", 8)) < 20.6e9
