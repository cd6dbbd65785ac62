"""The port's ssm family (mamba2-130m: an attention-free Mamba2 LM) held
against the JAX reference on the CPU, at the smoke config in float32.

Serving has no paged KV and no tiering step (the reference's fast budget
is 0 for the family), so the serve step is held in all three modes (which
it ignores, as the reference does) on the Mamba2 decode state and the
logits, with ``test_torch_configs.py``'s whole-decode bounds. The prefill
(``ssm_lm_forward``, every block's scan through the K8 op) is held
against the reference's prefill step; the port's decode equals its own
full-sequence forward; the launcher prints no ``tier_stat``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TieringConfig as JCfg
from repro.models import ssm as JS
from repro.serve.decode import init_serve_state as j_init
from repro_torch.configs import get_config as t_config
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.launch import serve as t_launch
from repro_torch.models import transformer as TF
from repro_torch.serve.decode import build_serve_step as t_build
from repro_torch.serve.decode import init_serve_state as t_init
from repro_torch.serve.decode import serve_exposition
from test_torch_configs import (MODES, TIGHT, prefill_matches_reference,
                                serve_matches_reference, tokens, weights)

CPU = "cpu"
ARCH = "mamba2_130m"


@pytest.mark.parametrize("mode", MODES)
def test_ssm_serve_step_matches_reference(mode):
    state = serve_matches_reference(ARCH, mode)
    assert sorted(state) == ["mamba"]
    with pytest.raises(ValueError, match="attention-free"):
        serve_exposition(state)


def test_ssm_prefill_matches_reference():
    prefill_matches_reference(ARCH)


def test_ssm_init_serve_state_matches_reference_shapes():
    _, _, cfg_j, cfg_t = weights(ARCH)
    want = j_init(cfg_j, JCfg(**TIGHT), 4, 16)
    got = t_init(cfg_t, TCfg(**TIGHT), 4, 16, device=CPU)
    assert sorted(got) == sorted(want) == ["mamba"]
    for f in JS.MambaCache._fields:
        g, w = getattr(got["mamba"], f), getattr(want["mamba"], f)
        assert tuple(g.shape) == w.shape, f
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), f


def test_ssm_decode_matches_forward():
    """The port's Mamba2 decode (the O(1)-state recurrence) equals its
    full-sequence forward (chunked SSD through the K8 op's plain version,
    4 chunks of 8) at every position."""
    _, model, _, cfg_t = weights(ARCH)
    steps = 32
    toks = torch.as_tensor(tokens(cfg_t, 4, steps, seed=7))
    step = t_build(cfg_t, TCfg(**TIGHT), 4, steps, device=CPU)
    state = t_init(cfg_t, TCfg(**TIGHT), 4, steps, device=CPU)
    outs = []
    with torch.no_grad():
        for i in range(steps):
            lg, state = step(model, state, toks[:, i:i + 1])
            outs.append(lg[:, 0])
        ref = TF.ssm_lm_forward(model, toks)
    err = float((torch.stack(outs, dim=1) - ref).abs().max()
                / ref.abs().max())
    assert err < 1e-4, err


def test_ssm_params_round_trip():
    """Reference tree -> ``SSMLM`` -> every leaf exact; the port's own init
    draws the same names; full width: 24 layers, 32 heads of 48."""
    params, model, _, cfg_t = weights(ARCH)
    host = jax.tree_util.tree_map(np.asarray, params)
    flat = {".".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(host)[0]}
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, v in flat.items():
        np.testing.assert_array_equal(got[name].numpy(), v, err_msg=name)
    own = TF.make_model(cfg_t, seed=3, device=CPU)
    assert isinstance(own, TF.SSMLM)
    assert sorted(n for n, _ in own.named_parameters()) == sorted(flat)
    full = t_config(ARCH)
    specs = TF.model_specs(full)
    assert tuple(specs["layers"]["A_log"].shape) == (24, 32)
    assert "attn" not in specs["layers"]


def test_ssm_serve_cli_runs_on_cpu(capsys):
    t_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                   "4", "--steps", "12"])
    out = capsys.readouterr().out
    assert "arch=mamba2-smoke" in out and "decoded 12 tokens x 4 seqs" in out
    assert "tier_stat" not in out and "migration trace" not in out
