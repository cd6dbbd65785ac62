"""The port's training pieces held against the JAX reference on the CPU:
the loss, the optimizer, the configs, the synthetic data, remat and
microbatching; and the repair that keeps serving and the prefill graph-free
once parameters are trainable.

The reference runs jitted (its rounding follows XLA's fusion). Bounds:

* ``cross_entropy``: within 2e-6 relative (a float32 logsumexp summed in
  another order).
* ``lr_schedule``: within 2 ulp (``jnp.cos`` and ``torch.cos`` differ in
  the last bit).
* ``global_norm``: within 2 ulp (the per-leaf sums reduce in another
  order); the clip's scaled gradients within 4 ulp of each leaf's scale.
* ``compress_grads_int8``: bitwise (IEEE division and product, round half
  to even in both; the scale's division by 127 is a product with its
  float32 reciprocal, as XLA rewrites it under ``jit``).
* ``adamw_update``: given the reference's own gradients and state, the
  parameters within 2 ulp of their magnitude (``PARAM_ULP``), m and v
  within 8 ulp of each leaf's scale (XLA contracts ``b1 * m + (1 - b1) *
  g`` into a fused multiply-add; torch rounds the product first; the
  gradient norm that scales every g differs by an ulp).
* ``synthetic_batch``, ``SyntheticLoader``: bitwise.
* remat "none" == "block" == "dots": gradients bitwise (the recomputation
  repeats the same float operations on the CPU).
* microbatches 2 vs 1: the reference's own bounds (parameters 2e-5, loss
  1e-4), and the averaged gradients within ``GRAD_ULP`` ulp of each leaf's
  scale and the gradient norm within ``GNORM_REL`` relative (the two split
  the same sums in another order). Against the reference's microbatched
  step: the loss within 1e-5 relative, the gradient norm within
  ``GNORM_REL``, and the parameters where |g| > ``G_MARGIN`` within
  ``PARAM_ULP`` ulp of the leaf's magnitude. (On this input the
  reference's own microbatched and whole-batch gradient norms differ by
  9e-6 relative, the port's from the reference's by 1.4e-5: float32 sums
  over a gradient that cancels, as in ``test_torch_train_archs``; a
  gradient summed without dividing by n, or from one microbatch only,
  moves the norm by far more.) Only where |g| <= ``G_MARGIN``
  may a parameter differ by ``2 lr + 1e-6``: Adam's first step moves each
  by lr sign(g), and a gradient that rounds to the other sign moves 2 lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs import shape_cells as j_shape_cells
from repro.configs import base as JB
from repro.data import pipeline as JP
from repro.models.params import init_params as j_init_params
from repro.models.transformer import model_specs as j_specs
from repro.optim import adamw as JA
from repro.train.step import cross_entropy as j_ce
from repro.train.step import make_train_step as j_train_step
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs import shape_cells
from repro_torch.configs import base as TB
from repro_torch.data import pipeline as TP
from repro_torch.models import transformer as TF
from repro_torch.models.params import abstract_params, param_bytes, \
    param_count
from repro_torch.optim import adamw as TA
from repro_torch.train.step import cross_entropy, make_loss_fn, \
    make_prefill_step, make_train_step
from test_torch_configs import serve_matches_reference, weights

CPU = "cpu"
ULP = 2.0 ** -23
PARAM_ULP = 2
STATE_ULP = 8
G_MARGIN = 1e-6
GRAD_ULP = 64
GNORM_REL = 5e-5


def J(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def host_tree(seed: int) -> dict:
    """A small nested float32 tree with a leaf whose size is not a multiple
    of 256 and one whose first block is all zeros."""
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(513,)) * 1e-3).astype(np.float32)
    z[:256] = 0
    return {"a": {"w": rng.normal(size=(37, 29)).astype(np.float32),
                  "b": rng.normal(size=(300,)).astype(np.float32)},
            "z": z}


def flat_torch(tree) -> dict:
    return {k: torch.as_tensor(np.array(v))
            for k, v in TA.flat_params(tree).items()}


def assert_close_ulp(got, want, ulps, scale=None, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    s = np.abs(want).max() if scale is None else scale
    assert np.abs(got - want).max() <= ulps * ULP * max(s, 1e-30), what


# -------------------------------------------------------------- loss ----
def test_cross_entropy_over_padded_vocab():
    rng = np.random.default_rng(0)
    v, pad = 50, 14
    logits = rng.normal(size=(3, 7, v + pad)).astype(np.float32) * 4
    logits[..., v:] = -1e9                        # padded vocab columns
    labels = rng.integers(0, v, (3, 7)).astype(np.int32)
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        want = float(jax.jit(j_ce)(jnp.asarray(logits, dt_j),
                                   jnp.asarray(labels)))
        got = float(cross_entropy(torch.as_tensor(logits).to(dt_t),
                                  torch.as_tensor(labels)))
        assert abs(got - want) <= 2e-6 * abs(want)


# --------------------------------------------------------- optimizer ----
@pytest.mark.parametrize("warmup,total", [(10, 50), (100, 1000), (0, 1)])
def test_lr_schedule_matches_reference(warmup, total):
    tc = JB.TrainConfig(warmup_steps=warmup, total_steps=total)
    tct = TB.TrainConfig(**dataclasses.asdict(tc))
    s = np.arange(0, total + 6, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda x: JA.lr_schedule(x, tc)))(s))
    got = TA.lr_schedule(torch.as_tensor(s), tct).numpy()
    assert_close_ulp(got, want, 2, scale=tc.learning_rate)
    # each step on its own (the scalar form the update uses)
    for i in (0, warmup, total, total + 5):
        one = TA.lr_schedule(torch.tensor(i, dtype=torch.int32), tct)
        assert one.dtype == torch.float32 and float(one) == float(got[i])


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    tree = host_tree(1)
    norm_j = float(jax.jit(JA.global_norm)(J(tree)))
    norm_t = float(TA.global_norm(flat_torch(tree)))
    assert abs(norm_t - norm_j) <= 2 * ULP * norm_j
    cj, nj = jax.jit(lambda t: JA.clip_by_global_norm(t, max_norm))(J(tree))
    ct, nt = TA.clip_by_global_norm(flat_torch(tree), max_norm)
    assert abs(float(nt) - float(nj)) <= 2 * ULP * float(nj)
    for k, v in TA.flat_params(jax.tree_util.tree_map(np.asarray, cj)
                               ).items():
        assert ct[k].dtype == torch.float32
        assert_close_ulp(ct[k].numpy(), v, 4, what=k)
    if max_norm > norm_j:                          # no clip: unchanged
        for k, v in flat_torch(tree).items():
            assert torch.equal(ct[k], v)


def test_global_norm_sums_in_reference_leaf_order():
    names = ["b.x", "a.z", "a.b_c", "a.b.d", "aa"]
    assert TA.tree_order(names) == ["a.b.d", "a.b_c", "a.z", "aa", "b.x"]
    want = [".".join(str(k.key) for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path(
                {"b": {"x": 0}, "a": {"z": 0, "b_c": 0, "b": {"d": 0}},
                 "aa": 0})[0]]
    assert TA.tree_order(names) == want


def test_compress_grads_int8_bitwise():
    tree = host_tree(2)
    half = np.zeros(300, np.float32)              # exact half-way values
    half[:8] = [0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5, 127.0]
    tree["h"] = half
    tree["big"] = np.random.default_rng(3).normal(
        size=(3, 1000)).astype(np.float32) * 1e4
    want = jax.tree_util.tree_map(
        np.asarray, jax.jit(JA.compress_grads_int8)(J(tree)))
    got = TA.compress_grads_int8(flat_torch(tree))
    for k, v in TA.flat_params(want).items():
        assert got[k].shape == v.shape
        assert np.array_equal(got[k].numpy().view(np.int32),
                              v.view(np.int32)), k
    # the all-zero block stays zero; half-way quotients round to even
    assert not got["z"][:256].any()
    q = torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5]))
    assert q.tolist() == [0.0, 2.0, 2.0, -0.0, -2.0]


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_reference(compress):
    """Five updates, each from the reference's own parameters, gradients
    and state; steps 1 and 5 are read (the warmup and the cosine
    branch)."""
    tc = JB.TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                        grad_compression=compress)
    tct = TB.TrainConfig(**dataclasses.asdict(tc))
    rng = np.random.default_rng(4)
    p = J(host_tree(5))
    opt = JA.init_opt_state(p)
    upd = jax.jit(lambda p, g, o: JA.adamw_update(p, g, o, tc))
    for step in range(1, 6):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), p)
        pt = flat_torch(jax.tree_util.tree_map(np.asarray, p))
        ot = convert.opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, opt), device=CPU)
        gt = flat_torch(jax.tree_util.tree_map(np.asarray, grads))
        p, opt, mj = upd(p, grads, opt)
        same, ot, mt = TA.adamw_update(pt, gt, ot, tct)
        assert all(same[k] is pt[k] for k in pt)          # in place
        if step not in (1, 5):
            continue
        assert int(ot.step) == step and ot.step.dtype == torch.int32
        assert abs(float(mt["lr"]) - float(mj["lr"])) <= 2 * ULP * 1e-2
        assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) \
            <= 2 * ULP * float(mj["grad_norm"])
        want = convert.opt_state_to_numpy(ot)
        ref = {"m": opt.m, "v": opt.v}
        for f in ("m", "v"):
            w = TA.flat_params(jax.tree_util.tree_map(np.asarray, ref[f]))
            g = TA.flat_params(want[f])
            for k in w:
                assert_close_ulp(g[k], w[k], STATE_ULP, what=f"{f} {k}")
        for k, v in TA.flat_params(jax.tree_util.tree_map(np.asarray, p)
                                   ).items():
            assert_close_ulp(pt[k].numpy(), v, PARAM_ULP, what=k)


def test_opt_state_conversions_round_trip():
    p = J(host_tree(6))
    opt = JA.init_opt_state(p)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       m=jax.tree_util.tree_map(lambda x: x + 1.5, opt.m))
    host = jax.tree_util.tree_map(np.asarray, opt)
    ot = convert.opt_state_from_numpy(host, device=CPU)
    assert list(ot.m) == TA.tree_order(ot.m) and int(ot.step) == 7
    back = convert.opt_state_to_numpy(ot)
    for f in ("m", "v"):
        for k, v in TA.flat_params(getattr(host, f)).items():
            assert np.array_equal(TA.flat_params(back[f])[k], v)
    assert back["step"].dtype == np.int32
    abstract = TA.abstract_opt_state(abstract_params(
        TF.model_specs(get_smoke_config("llama32_1b"))))
    assert all(t.is_meta and t.dtype == torch.float32
               for t in abstract.m.values())
    assert abstract.step.dtype == torch.int32


# ----------------------------------------------------------- configs ----
def test_train_and_shape_configs_match_reference():
    assert dataclasses.asdict(TB.TrainConfig()) == dataclasses.asdict(
        JB.TrainConfig())
    assert [f.name for f in dataclasses.fields(TB.TrainConfig)] == [
        f.name for f in dataclasses.fields(JB.TrainConfig)]
    assert [f.name for f in dataclasses.fields(TB.ShapeConfig)] == [
        f.name for f in dataclasses.fields(JB.ShapeConfig)]
    assert {k: dataclasses.asdict(v) for k, v in TB.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()}
    assert TB.SHAPES["decode_32k"].is_decode
    assert ARCH_IDS == list(J_ARCH_IDS)
    for arch in ARCH_IDS:
        assert [s.name for s in shape_cells(arch)] == [
            s.name for s in j_shape_cells(arch)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_and_abstract_params_match_reference(arch):
    from repro.models.params import abstract_params as j_abstract
    from repro.models.params import param_bytes as j_param_bytes
    from repro.models.params import param_count as j_param_count
    specs, jspecs = TF.model_specs(get_config(arch)), j_specs(j_config(arch))
    assert param_count(specs) == j_param_count(jspecs)
    assert param_bytes(specs) == j_param_bytes(jspecs)
    got = TA.flat_params(abstract_params(specs))
    want = TA.flat_params(jax.tree_util.tree_map(
        lambda s: s, j_abstract(jspecs)))
    assert list(got) == list(want)
    for k, s in want.items():
        assert got[k].is_meta and tuple(got[k].shape) == tuple(s.shape), k


# -------------------------------------------------------------- data ----
def _same_batch(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        t = got[k]
        if t.dtype == torch.bfloat16:
            assert v.dtype.name == "bfloat16", k
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  v.view(np.int16)), k
        else:
            assert str(t.dtype).endswith(v.dtype.name), k
            assert np.array_equal(t.numpy(), v), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_synthetic_batch_and_loader_bitwise(arch):
    cfg_t, cfg_j = get_smoke_config(arch), j_smoke(arch)
    for kind in ("train", "prefill"):
        _same_batch(TP.synthetic_batch(cfg_t, 3, 16, seed=11, kind=kind,
                                       device=CPU),
                    JP.synthetic_batch(cfg_j, 3, 16, seed=11, kind=kind))
    f32_t = dataclasses.replace(cfg_t, dtype="float32")
    f32_j = dataclasses.replace(cfg_j, dtype="float32")
    _same_batch(TP.synthetic_batch(f32_t, 2, 8, seed=3, device=CPU),
                JP.synthetic_batch(f32_j, 2, 8, seed=3))
    lt = TP.SyntheticLoader(cfg_t, 4, 8, seed=2, shard_id=1, num_shards=2,
                            device=CPU)
    lj = JP.SyntheticLoader(cfg_j, 4, 8, seed=2, shard_id=1, num_shards=2)
    for _ in range(3):
        _same_batch(next(lt), next(lj))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    cfg_t, cfg_j = get_config(arch), j_config(arch)
    for sh in shape_cells(arch):
        got = TP.input_specs(cfg_t, sh)
        want = JP.input_specs(cfg_j, JB.SHAPES[sh.name])
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert got[k].is_meta and tuple(got[k].shape) == s.shape
            assert str(got[k].dtype).split(".")[-1] == s.dtype.name


# ------------------------------------------------------------- remat ----
@pytest.mark.parametrize("arch", ["llama32_1b", "granite_moe_3b_a800m",
                                  "mamba2_130m", "zamba2_7b",
                                  "whisper_tiny", "llama32_vision_90b"])
def test_remat_policies_give_the_same_gradients(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    batch = TP.synthetic_batch(cfg, 2, 16, seed=5, device=CPU)
    grads = {}
    for policy in ("none", "block", "dots", "full"):
        model = TF.make_model(cfg, seed=1, device=CPU).requires_grad_(True)
        loss, _ = make_loss_fn(cfg, TB.TrainConfig(remat_policy=policy),
                               impl="ref")(model, batch)
        loss.backward()
        grads[policy] = {n: p.grad for n, p in model.named_parameters()}
    for policy in ("block", "dots", "full"):
        for n, g in grads["none"].items():
            assert torch.equal(grads[policy][n], g), (policy, n)


def test_remat_recomputes_only_under_autograd():
    calls = []

    def body(x):
        calls.append(1)
        return torch.sin(x)

    x = torch.ones(3, requires_grad=True)
    y = TF.make_remat(body, "block")(x)
    y.sum().backward()
    assert len(calls) == 2                         # forward + recompute
    with torch.no_grad():
        TF.make_remat(body, "block")(x)
    assert len(calls) == 3
    assert TF.make_remat(body, "none") is body


# ------------------------------------------------------- microbatches ----
def _j_state(cfg_j):
    params = j_init_params(jax.random.PRNGKey(0), j_specs(cfg_j))
    return params, JA.init_opt_state(params)


def test_microbatch_accumulation_matches_single_and_reference():
    cfg_j = dataclasses.replace(j_smoke("llama32_1b"), dtype="float32")
    cfg_t = dataclasses.replace(get_smoke_config("llama32_1b"),
                                dtype="float32")
    params, opt = _j_state(cfg_j)
    host = jax.tree_util.tree_map(np.asarray, params)
    batch = TP.synthetic_batch(cfg_t, 4, 16, device=CPU)
    out = {}
    for n in (1, 2):
        tc = TB.TrainConfig(microbatches=n, remat_policy="none")
        model = convert.params_from_numpy(host, cfg_t, device=CPU)
        ot, m = make_train_step(cfg_t, tc, device=CPU)(
            model, TA.init_opt_state(model), batch)
        out[n] = (TA.flat_params(model), m, ot)
        if n == 2:
            assert "ce" not in m and "moe_aux" not in m
        else:
            assert {"loss", "ce", "moe_aux", "grad_norm", "lr"} == set(m)
    p1, p2 = out[1][0], out[2][0]
    d = max(float((p1[k] - p2[k]).detach().abs().max()) for k in p1)
    assert d < 2e-5
    assert abs(float(out[1][1]["loss"]) - float(out[2][1]["loss"])) < 1e-4
    # the averaged gradients themselves, and the update they drive
    assert abs(float(out[1][1]["grad_norm"]) - float(out[2][1]["grad_norm"])
               ) <= GNORM_REL * float(out[1][1]["grad_norm"])
    for k in p1:
        assert_close_ulp(p2[k].grad.numpy(), p1[k].grad.numpy(), GRAD_ULP,
                         what=f"grad {k}")
    # the reference's microbatched step from the same state and batch
    tc = JB.TrainConfig(microbatches=2, remat_policy="none")
    bj = JP.synthetic_batch(cfg_j, 4, 16)
    pj, oj, mj = jax.jit(j_train_step(cfg_j, tc))(params, opt, bj)
    mt = out[2][1]
    assert abs(float(mt["loss"]) - float(mj["loss"])) \
        <= 1e-5 * abs(float(mj["loss"]))
    assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) \
        <= GNORM_REL * float(mj["grad_norm"])
    lr = float(mj["lr"])
    for k, v in TA.flat_params(jax.tree_util.tree_map(np.asarray, pj)
                               ).items():
        g = p2[k].grad.abs().numpy()
        got = p2[k].detach().numpy()
        big = g > G_MARGIN
        assert_close_ulp(got[big], v[big], PARAM_ULP,
                         scale=np.abs(v).max(), what=k)
        err = np.abs(got - v)[~big]
        assert err.size == 0 or err.max() <= 2 * lr + 1e-6, k
    assert int(out[2][2].step) == int(oj.step) == 1


# ---------------------------------------------------------- repairs ----
def test_train_step_makes_parameters_trainable_and_grads_land():
    cfg = get_smoke_config("llama32_1b")
    model = TF.make_model(cfg, seed=0, device=CPU)
    assert not any(p.requires_grad for p in model.parameters())
    step = make_train_step(cfg, TB.TrainConfig(), device=CPU)
    opt = TA.init_opt_state(model)
    batch = TP.synthetic_batch(cfg, 2, 8, device=CPU)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, m = step(model, opt, batch)
    for n, p in model.named_parameters():
        assert p.requires_grad and p.grad is not None, n
        assert torch.isfinite(p.grad).all(), n
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    assert all(not v.requires_grad for v in m.values())
    with pytest.raises(ValueError, match="impl='cuda'"):
        make_train_step(cfg, TB.TrainConfig(), impl="cuda", device=CPU)


def test_serve_and_prefill_record_no_graph_on_trainable_parameters():
    from repro_torch.configs.base import TieringConfig
    from repro_torch.serve.decode import build_serve_step, init_serve_state
    for arch in ("llama32_1b", "zamba2_7b", "mamba2_130m", "whisper_tiny"):
        cfg = get_smoke_config(arch)
        model = TF.make_model(cfg, seed=0, device=CPU).requires_grad_(True)
        tcfg = TieringConfig(n_tenants=2, n_fast_pages=8, n_slow_pages=16,
                             page_tokens=4)
        state = init_serve_state(cfg, tcfg, 2, 8, device=CPU)
        step = build_serve_step(cfg, tcfg, 2, 8, device=CPU)
        tok = torch.zeros((2, 1), dtype=torch.int32)
        for _ in range(3):
            logits, state = step(model, state, tok)
            assert logits.grad_fn is None and not logits.requires_grad
        batch = TP.synthetic_batch(cfg, 2, 8, kind="prefill", device=CPU)
        out = make_prefill_step(cfg, device=CPU)(model, batch)
        assert out.grad_fn is None and not out.requires_grad
        leaves = [v for v in state.values() if torch.is_tensor(v)] + [
            t for v in state.values() if isinstance(v, tuple)
            for t in v if torch.is_tensor(t)]
        assert all(t.grad_fn is None for t in leaves)
        assert all(p.grad is None for p in model.parameters())


def test_serve_matches_reference_with_trainable_parameters():
    model = weights("llama32_1b")[1]
    model.requires_grad_(True)
    try:
        serve_matches_reference("llama32_1b", "equilibria")
    finally:
        model.requires_grad_(False)
    assert all(p.grad is None for p in model.parameters())
