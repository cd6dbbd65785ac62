"""The encdec family (whisper-tiny) of the port held against the JAX
reference on the CPU, and the harness that ``test_torch_vlm.py`` shares.

At the smoke config in float32 (encoder_seq 16), weights come from the
reference's ``init_params`` through ``convert.params_from_numpy``, inputs
from numpy seeds, and the reference runs jitted (its rounding follows
XLA's fusion). The reference's init leaves the vlm's gates and the GELU
MLP's biases at zero, which hides the gated cross blocks and the bias path,
so every comparison first opens them: each gate and bias gets a nonzero
value drawn from a seed (gates in [0.5, 1.0]) in the reference's numpy
tree, before the tree crosses over. One test per family shows the
comparison is not vacuous: zeroing the cross K/V (and the vlm's gates)
moves the port's logits past the tolerance.

Bounds: forwards and layers within ``FWD_RTOL`` (1e-4) of the reference's
max |value| (float32 sums in another order); ``compute_cross_kv`` within
1e-5; serve steps integer KV state bitwise, float state within rtol/atol
1e-4 and logits within atol 1e-3 (``test_torch_configs.py``'s whole-decode
bounds); decode == forward within 1e-3 while pages move.
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
from repro.memtier import kvcache as JKC
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro.models.params import init_params as j_init_params
from repro.models.params import param_count as j_param_count
from repro.serve import decode as JSD
from repro.train.step import make_prefill_step as j_prefill
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config, \
    reduced_depth_config
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.launch import serve as t_launch
from repro_torch.memtier import kvcache as TKC
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TF
from repro_torch.serve import decode as TSD
from repro_torch.train.step import make_prefill_step as t_prefill
from test_torch_configs import F32_TOL, LOGIT_ATOL, MODES, TIGHT, tokens
from test_torch_serve import compare_cache

CPU = "cpu"
ARCH = "whisper_tiny"
B, STEPS = 8, 24
FWD_RTOL = 1e-4
CROSS_KV_ATOL = 1e-5
DECODE_ATOL = 1e-3
INPUT_SCALE = 0.1        # the reference's tests/test_serve.py encoder inputs


def T_(x):
    return torch.as_tensor(np.array(x))


def rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ------------------------------------------------------------- harness ----
def open_tree(host: dict, seed: int) -> dict:
    """A copy of a reference numpy parameter tree with every scalar gate
    (``gate``, ``gate_mlp``) drawn from U[0.5, 1.0] and every bias (``b1``,
    ``b2``) from N(0, 0.1), seeded: the paths the reference's zero init
    leaves dead."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("gate", "gate_mlp"):
                out[k] = rng.uniform(0.5, 1.0, v.shape).astype(v.dtype)
            elif k in ("b1", "b2"):
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(host)


@functools.lru_cache(maxsize=None)
def opened(arch: str):
    """(reference params, port model, float32 configs) of ``arch``'s smoke
    config, gates and biases opened (``open_tree``)."""
    cfg_j = dataclasses.replace(j_smoke(arch), dtype="float32")
    cfg_t = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    host = open_tree(jax.tree_util.tree_map(
        np.asarray, j_init_params(jax.random.PRNGKey(0), JTF.model_specs(
            cfg_j))), seed=3)
    params = jax.tree_util.tree_map(jnp.asarray, host)
    return params, convert.params_from_numpy(host, cfg_t, device=CPU), \
        cfg_j, cfg_t


def encoder_input(cfg, batch: int, seed: int) -> dict:
    """The batch's seeded encoder input: {"frames": [B, encoder_seq, d]} or
    {"image_embeds": [B, n_img, d]}, normal x ``INPUT_SCALE``."""
    key, n = (("frames", cfg.encoder_seq) if cfg.family == "encdec"
              else ("image_embeds", cfg.num_image_tokens))
    x = np.random.default_rng(seed).standard_normal(
        (batch, n, cfg.d_model)) * INPUT_SCALE
    return {key: x.astype(np.float32)}


def reference_encoded(arch: str, extra: dict) -> np.ndarray:
    """What the reference's cross-attention reads: the encoder's output
    (jitted) for the encdec, the image embeddings for the vlm."""
    params, _, cfg_j, _ = opened(arch)
    x = next(iter(extra.values()))
    if cfg_j.family != "encdec":
        return x
    return np.asarray(jax.jit(lambda p, f: JTF.encode_frames(
        p, f, cfg_j, remat="none"))(params, jnp.asarray(x)))


def reference_cross_kv(arch: str, enc: np.ndarray):
    """The reference's ``compute_cross_kv`` of ``enc``, jitted."""
    params, _, cfg_j, _ = opened(arch)
    ck, cv = jax.jit(lambda p, e: JSD.compute_cross_kv(p, cfg_j, e))(
        params, jnp.asarray(enc))
    return np.asarray(ck), np.asarray(cv)


def port_cross_kv(arch: str, extra: dict):
    """The port's cross K/V of the batch's encoder input, the whole way:
    ``encode_frames`` (encdec), then ``compute_cross_kv``."""
    _, model, _, cfg_t = opened(arch)
    x = T_(next(iter(extra.values())))
    with torch.no_grad():
        enc = (TF.encode_frames(model, x) if cfg_t.family == "encdec"
               else x)
        return TSD.compute_cross_kv(model, cfg_t, enc)


@functools.lru_cache(maxsize=None)
def serve_cross_kv(arch: str):
    """The cross K/V both serve runs start from: the reference's, of a
    seeded encoder input (the cross K/V cross over as the weights do)."""
    _, _, cfg_j, _ = opened(arch)
    return reference_cross_kv(arch, reference_encoded(
        arch, encoder_input(cfg_j, B, seed=5)))


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str, mode: str):
    """The reference's decode of ``tokens`` with its cross K/V filled: the
    per-step logits and host copies of the state after every step."""
    params, _, cfg_j, _ = opened(arch)
    tcfg = JCfg(**TIGHT)
    step = jax.jit(JSD.build_serve_step(cfg_j, tcfg, B, STEPS, mode=mode))
    state = JSD.init_serve_state(cfg_j, tcfg, B, STEPS)
    ck, cv = serve_cross_kv(arch)
    state["cross_k"], state["cross_v"] = jnp.asarray(ck), jnp.asarray(cv)
    toks = tokens(cfg_j, B, STEPS)
    logits, states = [], []
    for i in range(STEPS):
        lg, state = step(params, state, jnp.asarray(toks[:, i:i + 1]))
        logits.append(np.asarray(lg))
        states.append(jax.tree_util.tree_map(np.asarray, state))
    return logits, states


def serve_matches_reference(arch: str, mode: str):
    """``build_serve_step`` against the jitted reference step by step from
    the same cross K/V (``serve_cross_kv``): integer KV state bitwise, float
    state within ``F32_TOL``, logits within ``LOGIT_ATOL``, the cross K/V
    untouched. Returns the port's state."""
    logits, states = _jax_run(arch, mode)
    _, model, _, cfg_t = opened(arch)
    tcfg = TCfg(**TIGHT)
    step = TSD.build_serve_step(cfg_t, tcfg, B, STEPS, mode=mode, device=CPU)
    state = TSD.init_serve_state(cfg_t, tcfg, B, STEPS, device=CPU)
    assert sorted(state) == sorted(states[0])
    state["cross_k"], state["cross_v"] = (T_(x) for x in serve_cross_kv(
        arch))
    toks = torch.as_tensor(tokens(cfg_t, B, STEPS))
    rtol, atol = F32_TOL
    with torch.no_grad():
        for i in range(STEPS):
            lg, state = step(model, state, toks[:, i:i + 1])
            np.testing.assert_allclose(lg.numpy(), logits[i], rtol=0,
                                       atol=LOGIT_ATOL,
                                       err_msg=f"step {i} logits")
            compare_cache(convert.cache_to_numpy(state["kv"]),
                          states[i]["kv"], rtol=rtol, atol=atol,
                          msg=f"step {i}: ")
            for k in ("cross_k", "cross_v"):
                np.testing.assert_array_equal(state[k].numpy(), states[i][k])
    kv = state["kv"]
    assert kv.t == STEPS and int(kv.seq_len[0]) == STEPS
    if mode != "static":
        assert int(kv.counters.promotions.sum()
                   + kv.counters.demotions.sum()) > 0
    return state


def forward_matches_reference(arch: str) -> None:
    """``model_forward`` (impl "ref" and the wrapper's CPU route) against
    the reference's jitted forward, B=2, S=24, within ``FWD_RTOL``."""
    params, model, cfg_j, cfg_t = opened(arch)
    toks = tokens(cfg_j, 2, 24, seed=9)
    extra = encoder_input(cfg_j, 2, seed=4)
    want, _ = jax.jit(lambda p, b: JTF.model_forward(p, b, cfg_j,
                                                     remat="none"))(
        params, {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(v) for k, v in extra.items()}})
    batch = {"tokens": T_(toks), **{k: T_(v) for k, v in extra.items()}}
    with torch.no_grad():
        got = TF.model_forward(model, batch)
        last = TF.model_forward(model, batch, impl="ref", last_only=True)
    assert got.shape == (2, 24, cfg_t.vocab_size)
    assert rel(got.numpy(), want) < FWD_RTOL
    torch.testing.assert_close(last[:, 0], got[:, -1], rtol=0, atol=1e-6)


def prefill_matches_reference(arch: str) -> None:
    """``make_prefill_step`` with the batch's encoder input against the
    reference's jitted prefill step (B=3, S=64), within ``FWD_RTOL``;
    ``impl="ref"`` agrees exactly."""
    params, model, cfg_j, cfg_t = opened(arch)
    toks = tokens(cfg_j, 3, 64, seed=11)
    extra = encoder_input(cfg_j, 3, seed=12)
    want = jax.jit(j_prefill(cfg_j, TrainConfig(remat_policy="none")))(
        params, {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(v) for k, v in extra.items()}})
    batch = {"tokens": T_(toks), **{k: T_(v) for k, v in extra.items()}}
    got = t_prefill(cfg_t, device=CPU)(model, batch)
    assert got.shape == (3, cfg_t.vocab_size)
    assert rel(got.numpy(), want) < FWD_RTOL
    torch.testing.assert_close(
        t_prefill(cfg_t, impl="ref", device=CPU)(model, batch), got, rtol=0,
        atol=0)


def decode_matches_forward(arch: str):
    """The port's tiered decode with its cross K/V from ``compute_cross_kv``
    equals its full-sequence forward within ``DECODE_ATOL`` while pages
    sit in, and move between, both tiers (the reference's
    tests/test_serve.py:33-66 setup: B=2, 24 steps, ``TIGHT``). Returns
    (model, config, tokens, encoder input, decode logits) for the
    vacuity check."""
    _, model, _, cfg_t = opened(arch)
    tcfg = TCfg(**TIGHT)
    toks = torch.as_tensor(tokens(cfg_t, 2, STEPS, seed=7))
    extra = {k: T_(v) for k, v in encoder_input(cfg_t, 2, seed=8).items()}
    step = TSD.build_serve_step(cfg_t, tcfg, 2, STEPS, device=CPU)
    state = TSD.init_serve_state(cfg_t, tcfg, 2, STEPS, device=CPU)
    state["cross_k"], state["cross_v"] = port_cross_kv(
        arch, {k: v.numpy() for k, v in extra.items()})
    outs = []
    with torch.no_grad():
        for i in range(STEPS):
            lg, state = step(model, state, toks[:, i:i + 1])
            outs.append(lg[:, 0])
        ref = TF.model_forward(model, {"tokens": toks, **extra})
    dec = torch.stack(outs, dim=1)
    err = float((dec - ref).abs().max())
    assert err < DECODE_ATOL, err
    assert int((state["kv"].slow_page >= 0).sum()) > 0
    return model, cfg_t, toks, extra, dec


def zeroed_decode_moves(arch: str, dec, toks, zero_gates: bool) -> float:
    """Max |logit| change of the same decode with the cross K/V at zeros
    (the launcher's state) and, with ``zero_gates``, the vlm's gates
    closed again."""
    _, model, _, cfg_t = opened(arch)
    tcfg = TCfg(**TIGHT)
    step = TSD.build_serve_step(cfg_t, tcfg, 2, STEPS, device=CPU)
    state = TSD.init_serve_state(cfg_t, tcfg, 2, STEPS, device=CPU)
    saved = {}
    if zero_gates:
        cross = model.units["cross"]
        for k in ("gate", "gate_mlp"):
            saved[k] = cross[k].detach().clone()
            cross[k].data.zero_()
    try:
        outs = []
        with torch.no_grad():
            for i in range(STEPS):
                lg, state = step(model, state, toks[:, i:i + 1])
                outs.append(lg[:, 0])
    finally:
        for k, v in saved.items():
            model.units["cross"][k].data.copy_(v)
    return float((torch.stack(outs, dim=1) - dec).abs().max())


def params_match_reference(arch: str) -> None:
    """The port's tree has the reference's names and shapes, leaf for leaf
    (the crossed-over values exact), and the parameter counts agree at the
    full config and at depth 10."""
    params, model, _, _ = opened(arch)
    flat = {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, v in flat.items():
        np.testing.assert_array_equal(got[name].numpy(), v, err_msg=name)
    for cfg_t, cfg_j in ((get_config(arch), j_config(arch)),
                         (reduced_depth_config(arch, 10),
                          j_reduced(arch, 10))):
        assert spec_count(TF.model_specs(cfg_t)) == j_param_count(
            JTF.model_specs(cfg_j))
        assert TKC.kv_layer_count(cfg_t) == JKC.kv_layer_count(cfg_j)


def spec_count(specs: dict) -> int:
    return sum(spec_count(v) if isinstance(v, dict)
               else int(np.prod(v.shape)) for v in specs.values())


def cli_runs(arch: str, capsys) -> str:
    t_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                   "4", "--steps", "12", "--tenants", "2", "--protection",
                   "2", "--bound", "3"])
    out = capsys.readouterr().out
    assert "decoded 12 tokens x 4 seqs" in out and "tier_stat" in out
    return out


# ------------------------------------------------------------- layers ----
def test_sinusoid_is_bitwise_the_references():
    for seq, d in ((16, 64), (1500, 384)):
        got = TF._sinusoid(seq, d)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), JTF._sinusoid(seq, d))


def _layer0(arch: str):
    params, model, cfg_j, cfg_t = opened(arch)
    return (jax.tree_util.tree_map(lambda a: a[0], params["decoder"]),
            model.layer(0), cfg_j, cfg_t)


def _acts(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def test_attention_qkv_with_kv_x_matches_reference():
    """Cross projections: q from x [2, 12, d], k and v from enc [2, 16, d],
    no rope even with positions given; self projections still rope."""
    jp, tp, cfg_j, cfg_t = _layer0(ARCH)
    x, enc = _acts(cfg_j, (2, 12), 1), _acts(cfg_j, (2, 16), 2)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    for kw_j, kw_t in (({"kv_x": jnp.asarray(enc), "rope": False},
                        {"kv_x": T_(enc), "rope": False}),
                       ({"kv_x": jnp.asarray(enc)}, {"kv_x": T_(enc)}),
                       ({}, {})):
        want = jax.jit(lambda p, a, q: JL.attention_qkv(
            p["xattn"], a, cfg_j, q, **kw_j))(jp, jnp.asarray(x),
                                              jnp.asarray(pos))
        got = TL.attention_qkv(tp["xattn"], T_(x), cfg_t, T_(pos), **kw_t)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert rel(g.numpy(), w) < FWD_RTOL


def test_cross_attention_matches_reference():
    """Non-causal K7 (its plain version on the CPU) with more queries than
    keys (24 against 16) against the reference's ``attn_dense``."""
    jp, tp, cfg_j, cfg_t = _layer0(ARCH)
    x, enc = _acts(cfg_j, (2, 24), 3), _acts(cfg_j, (2, 16), 4)
    want = jax.jit(lambda p, a, e: JL.cross_attention(p["xattn"], a, e,
                                                      cfg_j))(
        jp, jnp.asarray(x), jnp.asarray(enc))
    got = TL.cross_attention(tp["xattn"], T_(x), T_(enc), cfg_t)
    assert rel(got.numpy(), want) < FWD_RTOL
    torch.testing.assert_close(
        TL.cross_attention(tp["xattn"], T_(x), T_(enc), cfg_t, impl="ref"),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("kv_len", [False, True])
def test_attn_decode_matches_reference(kv_len):
    """Single-query GQA attention against a contiguous [B, T, K, D] cache,
    with and without valid lengths."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
            for _ in range(2))
    lens = np.array([20, 7, 1], np.int32)
    want = jax.jit(lambda *a: JL.attn_decode(*a))(
        *(jnp.asarray(a) for a in (q, k, v)),
        *((jnp.asarray(lens),) if kv_len else ()))
    got = TL.attn_decode(T_(q), T_(k), T_(v), T_(lens) if kv_len else None)
    assert got.shape == (3, 1, 4, 16)
    assert rel(got.numpy(), want) < FWD_RTOL


def test_gelu_mlp_with_biases_matches_reference():
    """The tanh-form GELU with its (opened) biases; the erf form, which
    ``F.gelu`` takes by default, misses the bound."""
    jp, tp, cfg_j, cfg_t = _layer0(ARCH)
    x = _acts(cfg_j, (2, 12), 5) * 0.1
    want = jax.jit(lambda p, a: JL.mlp(p["mlp"], a, cfg_j))(
        jp, jnp.asarray(x))
    got = TL.mlp(tp["mlp"], T_(x), cfg_t)
    assert rel(got.numpy(), want) < FWD_RTOL
    p = tp["mlp"]
    erf = torch.nn.functional.gelu(T_(x) @ p["w1"] + p["b1"]) @ p["w2"] \
        + p["b2"]
    assert rel(erf.numpy(), want) > FWD_RTOL
    assert float(p["b1"].abs().min()) > 0 and float(p["b2"].abs().min()) > 0


# -------------------------------------------------------------- model ----
def test_encdec_params_and_counts_match_reference():
    params_match_reference(ARCH)
    full = get_config(ARCH)
    assert TKC.kv_layer_count(full) == 4
    assert reduced_depth_config(ARCH, 2).encoder_layers == 2


def test_encode_frames_matches_reference():
    """The encoder (non-causal K7 over 16 frames, no rope, ``enc_ln``)."""
    params, model, cfg_j, _ = opened(ARCH)
    frames = encoder_input(cfg_j, 2, seed=1)["frames"]
    want = jax.jit(lambda p, f: JTF.encode_frames(p, f, cfg_j,
                                                  remat="none"))(
        params, jnp.asarray(frames))
    got = TF.encode_frames(model, T_(frames))
    assert got.shape == (2, cfg_j.encoder_seq, cfg_j.d_model)
    assert rel(got.numpy(), want) < FWD_RTOL


def test_encdec_forward_matches_reference():
    forward_matches_reference(ARCH)


def test_encdec_compute_cross_kv_matches_reference():
    """[num_layers, B, encoder_seq, K, D] from the (reference's) encoder
    output."""
    _, model, cfg_j, cfg_t = opened(ARCH)
    enc = reference_encoded(ARCH, encoder_input(cfg_j, 3, seed=2))
    ck, cv = reference_cross_kv(ARCH, enc)
    got = TSD.compute_cross_kv(model, cfg_t, T_(enc))
    assert ck.shape == (cfg_j.num_layers, 3, cfg_j.encoder_seq,
                        cfg_j.num_kv_heads, cfg_j.resolved_head_dim)
    for g, w in zip(got, (ck, cv)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=CROSS_KV_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_encdec_serve_step_matches_reference(mode):
    serve_matches_reference(ARCH, mode)


def test_encdec_decode_matches_forward_and_cross_kv_matters():
    """Decode == forward with pages moving; the same decode with the cross
    K/V at zeros moves the logits far past the bound."""
    model, cfg_t, toks, extra, dec = decode_matches_forward(ARCH)
    assert zeroed_decode_moves(ARCH, dec, toks, zero_gates=False) \
        > 100 * DECODE_ATOL


def test_encdec_prefill_matches_reference():
    prefill_matches_reference(ARCH)


def test_encdec_serve_cli_runs_on_cpu(capsys):
    out = cli_runs(ARCH, capsys)
    assert "arch=whisper-smoke" in out
