"""The port's loss and gradients held against the JAX reference for every
architecture's smoke config, and the reference's "loss falls" property.

Each config is cast to float32 with ``dataclasses.replace``; weights are
the reference's ``init_params`` crossed over through
``convert.params_from_numpy``, with the encdec's biases and the vlm's gates
and biases opened (``open_tree``), so the gradients behind them are not
vacuously zero. The reference runs ``jax.value_and_grad`` of its
``make_loss_fn`` under ``jit``; the port ``make_loss_fn(impl="ref")`` and
``backward``. Bounds: the loss, ce and aux within ``LOSS_RTOL`` (1e-5)
relative; every gradient leaf within ``GRAD_RTOL`` (1e-3) of that leaf's
max |gradient| (float32 sums in another order, the SSD's chunk decays in
float64 here; the worst leaf measured is an attention key projection at
4e-4, where the gradient cancels).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import TrainConfig as JTC
from repro.data.pipeline import synthetic_batch as j_batch
from repro.models.params import init_params as j_init_params
from repro.models.transformer import model_specs as j_specs
from repro.train.step import make_loss_fn as j_loss_fn
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.step import make_loss_fn, make_train_step
from conftest import arch_params
from test_torch_encdec import open_tree

CPU = "cpu"
B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def host_weights(arch: str, dtype: str) -> dict:
    cfg_j = dataclasses.replace(j_smoke(arch), dtype=dtype)
    host = jax.tree_util.tree_map(np.asarray, j_init_params(
        jax.random.PRNGKey(0), j_specs(cfg_j)))
    return open_tree(host, seed=3)


def configs(arch: str, dtype: str):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_reference(arch):
    cfg_j, cfg_t = configs(arch, "float32")
    host = host_weights(arch, "float32")
    tc = JTC(remat_policy="none")
    (lj, exj), gj = jax.jit(jax.value_and_grad(
        j_loss_fn(cfg_j, tc), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, host), j_batch(cfg_j, B, S,
                                                           seed=1))
    model = convert.params_from_numpy(host, cfg_t, device=CPU)
    model.requires_grad_(True)
    lt, ext = make_loss_fn(cfg_t, TrainConfig(remat_policy="block"),
                           impl="ref")(model, synthetic_batch(
                               cfg_t, B, S, seed=1, device=CPU))
    lt.backward()
    for got, want in ((lt, lj), (ext["ce"], exj["ce"]),
                      (ext["moe_aux"], exj["moe_aux"])):
        assert abs(float(got) - float(want)) <= LOSS_RTOL * max(
            abs(float(want)), 1e-6)
    if cfg_t.family == "moe":
        assert float(ext["moe_aux"]) > 0
    flat = {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(gj)[0]}
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, want in flat.items():
        g = got[name].grad.numpy()
        scale = np.abs(want).max()
        assert scale > 0, f"{name}: the reference's gradient is zero"
        assert np.abs(g - want).max() <= GRAD_RTOL * scale, name


@pytest.mark.parametrize("arch", arch_params())
def test_train_step_decreases_loss_and_finite(arch):
    """The reference's tests/test_models.py property on the port: four
    steps on one batch in the config's own dtype (bf16 compute)."""
    _, cfg = configs(arch, get_smoke_config(arch).dtype)
    tc = TrainConfig(learning_rate=5e-3, warmup_steps=1, total_steps=20,
                     remat_policy="none", grad_clip=1.0)
    model = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_init_params(
            jax.random.PRNGKey(0), j_specs(j_smoke(arch)))), cfg,
        device=CPU)
    opt = init_opt_state(model)
    step = make_train_step(cfg, tc, device=CPU)
    batch = synthetic_batch(cfg, 2, 16, kind="train", device=CPU)
    losses = []
    for _ in range(4):
        opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]  # overfits one batch
    assert all(torch.isfinite(p).all() for p in model.parameters())
