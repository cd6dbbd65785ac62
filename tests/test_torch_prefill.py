"""The port's prefill path held against the JAX reference on the CPU: the
plain versions of K7 (flash attention) and K8 (SSD scan), the Mamba2 block,
the hybrid and dense full-sequence forwards and ``make_prefill_step``.

Each test gives both packages the same seeded numpy inputs (weights from
the reference's ``init_params``, crossing over through
``convert.params_from_numpy``); reference functions that hold float
arithmetic run jitted, as the reference runs them. K7 within 2e-5 and K8
within atol 1e-4 / rtol 5e-2 (the reference's own kernel-test tolerances,
tests/test_kernels.py, float32); forwards within 1e-4 of max |logit|
(float32 sums taken in another order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import TrainConfig
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd
from repro.models import ssm as JS
from repro.models.params import init_params as j_init_params
from repro.models.transformer import model_forward as j_forward
from repro.models.transformer import model_specs as j_specs
from repro.train.step import make_prefill_step as j_prefill
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels.flash_attention import ops as TFA
from repro_torch.kernels.flash_attention import ref as TFA_REF
from repro_torch.kernels.ssd_decode import ops as TSDEC
from repro_torch.kernels.ssd_decode import ref as TSDEC_REF
from repro_torch.kernels.ssd_scan import ops as TSSD
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TF
from repro_torch.train.step import make_prefill_step as t_prefill
from test_torch_gpu import (FLASH_CROSS_SHAPES, FLASH_MASKS, FLASH_SHAPES,
                            SSD_SHAPES,
                            flash_case, ssd_case, ssd_decode_case)
from repro_torch.kernels.ssd_scan import ref as TSSD_REF

CPU = "cpu"
FWD_RTOL = 1e-4
# tests/test_kernels.py's flash-attention grid, plus the port's widths:
# zamba2's head dim 112 and h2o-danube's 120 (the reference's wrapper pads
# it to 128 lanes of zeros, as the card's TMA fills the tiles past D)
REF_FLASH = FLASH_SHAPES[:4] + [FLASH_SHAPES[4], (1, 4, 2, 128, 128, 120)]


def T_(x):
    return torch.as_tensor(np.array(x))


@functools.lru_cache(maxsize=None)
def _model(arch: str, head_dim=None):
    """(reference params, port model, float32 configs) of ``arch``'s smoke
    config (its head dim replaced by ``head_dim`` if given)."""
    cfg_j = dataclasses.replace(j_smoke(arch), dtype="float32")
    cfg_t = dataclasses.replace(t_smoke(arch), dtype="float32")
    if head_dim is not None:
        cfg_j = dataclasses.replace(cfg_j, head_dim=head_dim)
        cfg_t = dataclasses.replace(cfg_t, head_dim=head_dim)
    params = j_init_params(jax.random.PRNGKey(0), j_specs(cfg_j))
    host = jax.tree_util.tree_map(np.asarray, params)
    return params, convert.params_from_numpy(host, cfg_t, device=CPU), \
        cfg_j, cfg_t


def _tokens(cfg, batch, seq, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ------------------------------------------------------------------- K7 ----
@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("shape", REF_FLASH)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_plain_matches_reference(shape, causal, window,
                                                  impl):
    q, k, v = flash_case(shape)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, impl=impl, block_q=64,
                   block_k=64)
    got = TFA.flash_attention(T_(q), T_(k), T_(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("shape", FLASH_SHAPES[5:])
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_ragged_lengths_match_reference(shape, causal,
                                                        window):
    """Lengths that are not a multiple of a tile (the TPU kernel asserts
    divisibility; the port's kernel masks its tail tiles): the plain
    version against the reference's plain version."""
    q, k, v = flash_case(shape)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, impl="ref")
    got = TFA.flash_attention(T_(q), T_(k), T_(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("shape", FLASH_CROSS_SHAPES)
def test_flash_attention_cross_plain_matches_reference(shape):
    """Full attention with more queries than keys (cross-attention at the
    card tests' ragged key counts): the plain version against the
    reference's plain version, which computes it with the same (unread)
    negative query offset."""
    q, k, v = flash_case(shape, seed=shape[4])
    want = jax.jit(lambda *a: j_flash_ref(*a, causal=False))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = TFA.flash_attention(T_(q), T_(k), T_(v), causal=False)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_attention_impl_ref_and_wrapper_agree_on_cpu():
    """On a CPU tensor the wrapper takes the plain version and counts no
    launch; ``impl="ref"`` is the plain version too."""
    q, k, v = (T_(x) for x in flash_case(FLASH_SHAPES[0]))
    before = TFA.flash_attention.launches
    a = TFA.flash_attention(q, k, v, window=64)
    b = TFA.flash_attention(q, k, v, window=64, impl="ref")
    assert torch.equal(a, b)
    assert torch.equal(a, TFA_REF.flash_attention_ref(q, k, v, window=64))
    assert TFA.flash_attention.launches == before
    with pytest.raises(ValueError, match="impl"):
        TFA.flash_attention(q, k, v, impl="pallas")


# ------------------------------------------------------------------- K8 ----
def _ssd_ref_inputs(x, a, bb, cc):
    """Per-head B/C for the reference (groups broadcast by jnp.repeat)."""
    rep = x.shape[2] // bb.shape[2]
    return (jnp.asarray(x), jnp.asarray(a),
            jnp.repeat(jnp.asarray(bb), rep, axis=2),
            jnp.repeat(jnp.asarray(cc), rep, axis=2))


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("decay", ["test", "init", "strong"])
def test_ssd_scan_plain_matches_reference(shape, decay):
    """The port's plain K8 against the reference's interpret-mode kernel and
    its O(S) recurrence."""
    x, a, bb, cc = ssd_case(shape, decay=decay)
    chunk = shape[5]
    y, h = TSSD.ssd_scan(T_(x), T_(a), T_(bb), T_(cc), chunk=chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    args = _ssd_ref_inputs(x, a, bb, cc)
    y_i, h_i = j_ssd(*args, chunk=chunk, impl="pallas_interpret")
    y_r, h_r = jax.jit(JS.ssd_recurrent_ref)(*args)
    for want_y, want_h in ((y_i, h_i), (y_r, h_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4,
                                   rtol=5e-2)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-4,
                                   rtol=5e-2)


def test_ssd_recurrent_ref_matches_reference():
    x, a, bb, cc = ssd_case(SSD_SHAPES[0])
    args = _ssd_ref_inputs(x, a, bb, cc)
    y, h = TS.ssd_recurrent_ref(*(T_(np.asarray(t)) for t in args))
    y_r, h_r = jax.jit(JS.ssd_recurrent_ref)(*args)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=1e-5,
                               rtol=1e-5)


def test_ssd_scan_rejects_ragged_chunks_and_counts_no_cpu_launch():
    x, a, bb, cc = (T_(t) for t in ssd_case(SSD_SHAPES[0]))
    before = TSSD.ssd_scan.launches
    y, h = TSSD.ssd_scan(x, a, bb, cc, chunk=16)
    y_r, h_r = TSSD.ssd_scan(x, a, bb, cc, chunk=16, impl="ref")
    assert torch.equal(y, y_r) and torch.equal(h, h_r)
    assert TSSD.ssd_scan.launches == before
    with pytest.raises(ValueError, match="multiple"):
        TSSD.ssd_scan(x, a, bb, cc, chunk=24)


# The CUDA kernels' algorithm (csrc/prefill.cu: ssd_chunk_state_kernel,
# ssd_state_pass_kernel, ssd_chunk_out_kernel), modelled in torch so that
# its split points and order of operations are pinned where no kernel
# runs: chunk states summed over 64-row tiles, the state pass multiplying
# one chunk's decay at a time, chunk outputs per 64-row tile with key tiles
# j <= i; a_cum and its differences in float64, rounded once before exp,
# L selected to 0 above the diagonal.
def ssd_split_model(x, a, b, c, chunk: int, tile: int = 64):
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc, f32 = S // chunk, torch.float32
    bh = torch.repeat_interleave(b, H // G, dim=2).to(f32).reshape(
        B, nc, chunk, H, N)
    ch = torch.repeat_interleave(c, H // G, dim=2).to(f32).reshape(
        B, nc, chunk, H, N)
    xr = x.to(f32).reshape(B, nc, chunk, H, P)
    acum = a.to(torch.float64).reshape(B, nc, chunk, H).cumsum(dim=2)
    a_last = acum[:, :, -1]                                     # [B,nc,H]
    w = torch.exp((a_last[:, :, None] - acum).to(f32))          # [B,nc,Q,H]
    # 1. chunk states s_c [N, P], summed tile by tile
    states = torch.zeros((B, nc, H, N, P))
    for r0 in range(0, chunk, tile):
        r = slice(r0, r0 + tile)
        states = states + torch.einsum(
            "bcrhn,bcrhp->bchnp", bh[:, :, r] * w[:, :, r, :, None], xr[:, :, r])
    # 2. the state pass: h_in[c] = h; h = exp(A_c) h + s_c
    h = torch.zeros((B, H, N, P))
    h_in = []
    for cc in range(nc):
        h_in.append(h)
        h = torch.exp(a_last[:, cc].to(f32))[..., None, None] * h + \
            states[:, cc]
    h_in = torch.stack(h_in, dim=1)                             # [B,nc,H,N,P]
    # 3. chunk outputs, 64-row tile i against key tiles j <= i
    y = torch.empty((B, nc, chunk, H, P))
    for i0 in range(0, chunk, tile):
        i = slice(i0, i0 + tile)
        gi = torch.arange(i0, min(i0 + tile, chunk))
        yi = torch.einsum("bcihn,bchnp->bcihp", ch[:, :, i], h_in) * \
            torch.exp(acum[:, :, i].to(f32))[..., None]
        for j0 in range(0, i0 + 1, tile):
            j = slice(j0, j0 + tile)
            gj = torch.arange(j0, min(j0 + tile, chunk))
            sc = torch.einsum("bcihn,bcjhn->bcijh", ch[:, :, i], bh[:, :, j])
            diff = (acum[:, :, i, None] - acum[:, :, None, j]).to(f32)
            tri = (gi[:, None] >= gj[None, :])[None, None, :, :, None]
            sc = torch.where(tri, sc * torch.exp(diff), 0.0)
            yi = yi + torch.einsum("bcijh,bcjhp->bcihp", sc, xr[:, :, j])
        y[:, :, i] = yi
    return y.reshape(B, S, H, P), h.transpose(-1, -2).contiguous()


# (b, s, h, p, n, chunk, g): the card tests' shapes, then one chunk over
# the whole sequence, 128 chunks at a small width, and a chunk of 96 (a
# 64-row tile and a 32-row one)
SSD_MODEL_SHAPES = SSD_SHAPES + [(1, 64, 2, 16, 8, 64, 1),
                                 (1, 1024, 2, 8, 8, 8, 1),
                                 (1, 192, 2, 16, 16, 96, 2)]


@pytest.mark.parametrize("shape", SSD_MODEL_SHAPES)
@pytest.mark.parametrize("decay", ["test", "init", "strong"])
def test_ssd_split_model_matches_plain_and_reference(shape, decay):
    """The kernels' chunk-parallel split within the card bound (atol 1e-5,
    rtol 1e-4) of the plain version, and within the reference's kernel-test
    bound (atol 1e-4, rtol 5e-2) of its Pallas kernel in interpret mode."""
    x, a, bb, cc = ssd_case(shape, decay=decay)
    chunk = shape[5]
    y, h = ssd_split_model(T_(x), T_(a), T_(bb), T_(cc), chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y_p, h_p = TSSD_REF.ssd_scan_ref(T_(x), T_(a), T_(bb), T_(cc), chunk)
    torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=1e-4)
    y_i, h_i = j_ssd(*_ssd_ref_inputs(x, a, bb, cc), chunk=chunk,
                     impl="pallas_interpret")
    np.testing.assert_allclose(y.numpy(), np.asarray(y_i), atol=1e-4,
                               rtol=5e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_i), atol=1e-4,
                               rtol=5e-2)


# -------------------------------------------------------------- pieces ----
def test_softplus_is_logaddexp_beyond_20():
    x = np.array([-30.0, -1.0, 0.0, 19.0, 20.5, 25.0, 80.0], np.float32)
    np.testing.assert_array_equal(TS.softplus(T_(x)).numpy(),
                                  np.asarray(jax.jit(jax.nn.softplus)(x)))


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.3).astype(np.float32)
    want = jax.jit(JS._causal_conv)(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(TS._causal_conv(T_(x), T_(w)).numpy(),
                               np.asarray(want), atol=1e-6, rtol=1e-6)


def _state_update(h, da, xh, bg, dt):
    return TS.state_update(h, da, xh, torch.repeat_interleave(
        bg, xh.shape[1] // bg.shape[1], dim=1), dt)


def _decode_ref_state(h, da, xh, bg, dt):
    D = torch.ones(xh.shape[1])
    return TSDEC_REF.ssd_decode_ref(h, xh, bg, bg, dt, da, D)[0]


@pytest.mark.parametrize("update,G", [(_state_update, 8),
                                      (_decode_ref_state, 2)],
                         ids=["state_update", "ssd_decode_ref"])
def test_decode_state_update_is_bitwise(update, G):
    """h * da + einsum("bhn,bhp,bh->bhpn", b, x, dt), as the jitted
    reference rounds it (ssm.py ``mamba_decode_step``): ``state_update``
    (a b of its own for every head) and the decode-state kernel's plain
    version (2 groups of 4 heads)."""
    rng = np.random.default_rng(4)
    B, H, P, N = 3, 8, 16, 16
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    da, dt = (rng.random((B, H)).astype(np.float32) for _ in range(2))
    bg = rng.standard_normal((B, G, N)).astype(np.float32)
    xh = rng.standard_normal((B, H, P)).astype(np.float32)
    want = jax.jit(lambda h, da, bh, xh, dt: h * da[..., None, None]
                   + jnp.einsum("bhn,bhp,bh->bhpn", bh, xh, dt))(
        h, da, np.repeat(bg, H // G, axis=1), xh, dt)
    got = update(T_(h), T_(da), T_(xh), T_(bg), T_(dt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", TSDEC.IMPLS)
def test_ssd_decode_on_cpu_is_the_plain_expression(dtype, impl):
    """On CPU tensors the wrapper takes the plain route under either impl:
    the decode step's expression before the kernel (``state_update`` on
    repeated groups, the read-out einsum, the D skip) exactly, a new state
    (the input untouched) and no launch."""
    h, x, b, c, dt, da, D = (T_(a) for a in ssd_decode_case(
        (3, 8, 16, 16, 2), seed=1))
    x, b, c = (t.to(dtype) for t in (x, b, c))
    h0 = h.clone()
    before = TSDEC.ssd_decode.launches
    got_h, got_y = TSDEC.ssd_decode(h, x, b, c, dt, da, D, impl=impl)
    f32 = torch.float32
    xh = x.to(f32)
    bh = torch.repeat_interleave(b, 4, dim=1).to(f32)
    ch = torch.repeat_interleave(c, 4, dim=1).to(f32)
    want_h = TS.state_update(h0, da, xh, bh, dt)
    want_y = (torch.einsum("bhn,bhpn->bhp", ch, want_h)
              + D[None, :, None] * xh)
    assert torch.equal(got_h, want_h) and torch.equal(got_y, want_y)
    assert torch.equal(h, h0) and got_h is not h
    assert TSDEC.ssd_decode.launches == before


SSD_DECODE_BAD = {
    "h_not_contiguous": lambda a: {**a, "h": torch.zeros(
        (3, 8, 16, 32))[..., :16]},
    "h_float64": lambda a: {**a, "h": a["h"].double()},
    "x_float16": lambda a: {**a, "x": a["x"].half()},
    "b_not_x_dtype": lambda a: {**a, "b": a["b"].bfloat16()},
    "n_not_multiple_of_4": lambda a: {
        **a, "h": torch.zeros((3, 8, 16, 6)), "b": torch.zeros((3, 2, 6)),
        "c": torch.zeros((3, 2, 6))},
    "n_over_128": lambda a: {
        **a, "h": torch.zeros((3, 8, 16, 132)),
        "b": torch.zeros((3, 2, 132)), "c": torch.zeros((3, 2, 132))},
}


@pytest.mark.parametrize("bad", list(SSD_DECODE_BAD))
@pytest.mark.parametrize("impl", TSDEC.IMPLS)
def test_ssd_decode_refuses_what_the_kernel_does_not_take(bad, impl):
    """Both routes raise, before any launch, on what the kernel does not
    take: a non-contiguous state, a wrong dtype, N not a multiple of 4 or
    over 128."""
    names = ("h", "x", "b", "c", "dt", "da", "D")
    args = dict(zip(names, (T_(a) for a in ssd_decode_case(
        (3, 8, 16, 16, 2), seed=2))))
    args = SSD_DECODE_BAD[bad](args)
    before = TSDEC.ssd_decode.launches
    with pytest.raises(ValueError, match="ssd_decode"):
        TSDEC.ssd_decode(*(args[k] for k in names), impl=impl)
    assert TSDEC.ssd_decode.launches == before


def _layer0(arch="zamba2_7b"):
    params, model, cfg_j, cfg_t = _model(arch)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    return jp, model.layer(0), cfg_j, cfg_t


@pytest.mark.parametrize("seq", [8, 16, 5])
def test_mamba_block_matches_reference(seq):
    """One Mamba2 block at the smoke config (chunk 8; a 5-step prompt runs
    one chunk of 5, as the reference's ``min(chunk, S)``)."""
    jp, tp, cfg_j, cfg_t = _layer0()
    u = np.random.default_rng(seq).standard_normal(
        (2, seq, cfg_j.d_model)).astype(np.float32)
    want_x, want_h = jax.jit(lambda p, u: JS.mamba_block(p, u, cfg_j))(
        jp, jnp.asarray(u))
    got_x, got_h = TS.mamba_block(tp, T_(u), cfg_t)
    assert _rel(got_x.numpy(), want_x) < FWD_RTOL
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5,
                               rtol=1e-4)
    ref_x, _ = TS.mamba_block(tp, T_(u), cfg_t, impl="ref")
    assert torch.equal(ref_x, got_x)


def test_mamba_decode_step_matches_reference():
    """Eight decode steps of one block from a zero cache, against the jitted
    reference step; then the decode equals the block's forward."""
    jp, tp, cfg_j, cfg_t = _layer0()
    B, steps = 2, 8
    u = np.random.default_rng(5).standard_normal(
        (B, steps, cfg_j.d_model)).astype(np.float32)
    j_step = jax.jit(lambda p, u, c: JS.mamba_decode_step(p, u, c, cfg_j))
    spec = JS.mamba_cache_specs(cfg_j, B, 1)
    j_cache = JS.MambaCache(*(jnp.zeros(s.shape[1:], s.dtype) for s in spec))
    t_cache = TS.MambaCache(*(c[0] for c in TS.init_mamba_cache(
        cfg_t, B, 1, device=CPU)))
    outs = []
    for i in range(steps):
        wx, j_cache = j_step(jp, jnp.asarray(u[:, i:i + 1]), j_cache)
        gx, t_cache = TS.mamba_decode_step(tp, T_(u[:, i:i + 1]), t_cache,
                                           cfg_t)
        assert _rel(gx.numpy(), wx) < FWD_RTOL, i
        for f in TS.MambaCache._fields:
            np.testing.assert_allclose(getattr(t_cache, f).numpy(),
                                       np.asarray(getattr(j_cache, f)),
                                       atol=1e-5, rtol=1e-4, err_msg=f)
        outs.append(gx)
    full, h = TS.mamba_block(tp, T_(u), cfg_t)
    assert _rel(torch.cat(outs, 1).numpy(), full.numpy()) < FWD_RTOL
    np.testing.assert_allclose(t_cache.h.numpy(), h.numpy(), atol=1e-5,
                               rtol=1e-4)


# ------------------------------------------------------------ forwards ----
@pytest.mark.parametrize("arch", ["zamba2_7b", "llama32_1b"])
@pytest.mark.parametrize("seq", [16, 24])
def test_forward_matches_reference(arch, seq):
    """``hybrid_forward`` / ``lm_forward`` (self-attention through the K7
    op, Mamba2 through the K8 op) against the reference's jitted
    ``model_forward``; ``impl="ref"`` agrees."""
    params, model, cfg_j, _ = _model(arch)
    toks = _tokens(cfg_j, 2, seq, seed=seq)
    want, _ = jax.jit(lambda p, t: j_forward(p, {"tokens": t}, cfg_j,
                                             remat="none"))(
        params, jnp.asarray(toks))
    with torch.no_grad():
        got = TF.model_forward(model, {"tokens": T_(toks)})
        ref = TF.model_forward(model, {"tokens": T_(toks)}, impl="ref")
    assert _rel(got.numpy(), want) < FWD_RTOL
    assert torch.allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["zamba2_7b", "llama32_1b"])
def test_prefill_step_matches_reference(arch):
    """``make_prefill_step``: the last position's logits, against the
    reference's prefill step (its full forward, then ``logits[:, -1]``)."""
    params, model, cfg_j, cfg_t = _model(arch)
    toks = _tokens(cfg_j, 3, 16, seed=11)
    want = jax.jit(j_prefill(cfg_j, TrainConfig(remat_policy="none")))(
        params, {"tokens": jnp.asarray(toks)})
    got = t_prefill(cfg_t, device=CPU)(model, {"tokens": T_(toks)})
    assert got.shape == (3, cfg_t.vocab_size)
    assert _rel(got.numpy(), want) < FWD_RTOL
    with torch.no_grad():
        full = TF.model_forward(model, {"tokens": T_(toks)}, impl="ref")
    torch.testing.assert_close(got, full[:, -1], atol=1e-5, rtol=1e-5)


def test_danube_head_dim_120_prefill_matches_reference():
    """A narrow h2o-danube (2 layers, H=4, K=2, window 32) at its real head
    dim of 120, which the smoke config's 16 does not reach: ``make_prefill_
    step`` at S=64 (past the window) against the reference's jitted
    prefill step; ``impl="ref"`` agrees."""
    params, model, cfg_j, cfg_t = _model("h2o_danube_3_4b", head_dim=120)
    assert (cfg_t.resolved_head_dim, cfg_t.num_layers, cfg_t.num_heads,
            cfg_t.num_kv_heads, cfg_t.sliding_window) == (120, 2, 4, 2, 32)
    toks = _tokens(cfg_j, 2, 64, seed=120)
    want = jax.jit(j_prefill(cfg_j, TrainConfig(remat_policy="none")))(
        params, {"tokens": jnp.asarray(toks)})
    got = t_prefill(cfg_t, device=CPU)(model, {"tokens": T_(toks)})
    assert got.shape == (2, cfg_t.vocab_size)
    assert _rel(got.numpy(), want) < FWD_RTOL
    ref = t_prefill(cfg_t, impl="ref", device=CPU)(model,
                                                   {"tokens": T_(toks)})
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_self_attention_matches_reference_dense_path():
    """``layers.self_attention`` against the reference's at a length where
    the reference takes ``attn_dense`` and, with a window shorter than the
    prompt, ``attn_local``."""
    from repro.models import layers as JL
    params, model, cfg_j, cfg_t = _model("llama32_1b")
    jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
    tp = model.layer(0)["attn"]
    x = np.random.default_rng(2).standard_normal(
        (2, 32, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    for window in (None, 8):
        want = jax.jit(lambda p, x: JL.self_attention(
            p, x, cfg_j, jnp.asarray(pos), causal=True, window=window))(
            jp, jnp.asarray(x))
        got = TL.self_attention(tp, T_(x), cfg_t, T_(pos), window=window)
        assert _rel(got.numpy(), want) < FWD_RTOL, window


def test_unported_family_raises():
    """Every family is ported: an unknown family raises ``ValueError``, as
    the reference's router does, and every reference architecture's smoke
    config builds, prefills and serves on the CPU."""
    from repro.configs import ARCH_IDS as J_IDS
    from repro_torch.configs.base import TieringConfig
    from repro_torch.serve.decode import build_serve_step, init_serve_state
    cfg = dataclasses.replace(t_smoke("llama32_1b"), family="retnet")
    for fn in (TF.model_specs, lambda c: t_prefill(c, device=CPU),
               lambda c: TF.make_model(c, device=CPU)):
        with pytest.raises(ValueError, match="unknown family"):
            fn(cfg)
    with pytest.raises(ValueError, match="make_model"):
        TF.HybridLM(t_smoke("llama32_1b"), device=CPU)
    tcfg = TieringConfig(n_tenants=2, page_tokens=4)
    for arch in J_IDS:
        cfg = t_smoke(arch)
        model = TF.make_model(cfg, device=CPU)
        toks = torch.as_tensor(_tokens(cfg, 2, 8, seed=1))
        batch = {"tokens": toks}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(2, cfg.encoder_seq, cfg.d_model)
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros(2, cfg.num_image_tokens,
                                                cfg.d_model)
        logits = t_prefill(cfg, device=CPU)(model, batch)
        assert logits.shape == (2, cfg.vocab_size), arch
        assert bool(torch.isfinite(logits).all()), arch
        state = init_serve_state(cfg, tcfg, 2, 8, device=CPU)
        step = build_serve_step(cfg, tcfg, 2, 8, device=CPU)
        with torch.no_grad():
            lg, state = step(model, state, toks[:, :1])
        assert lg.shape == (2, 1, cfg.vocab_size), arch
