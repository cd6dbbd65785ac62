"""The arithmetic of K7's float32 route on the card (the tf32x3 kernel in
``csrc/prefill.cu``), emulated in plain torch on the CPU and held against
the JAX reference's K7 (interpret mode and its plain version).

The kernel splits every float32 operand as x = hi + lo with hi and lo
rounded to TF32 (10 fraction bits, to nearest, ties away from zero), and
takes a product as lo_a hi_b + hi_a lo_b + hi_a hi_b (3xTF32): S = (scale Q)
K^T, and P V with p split as well, over 64-key tiles with the online
softmax p = exp(s - m). The emulation below does the same: each TF32
product is exact in float32 (11 x 11 significant bits), and each tile's
sum is added in float32, as the kernel adds its tensor-core accumulators.
It shows that the split keeps K7's float32 tolerance (2e-5, the
reference's tests/test_kernels.py) where one TF32 product does not, and
that bf16 inputs split with lo == 0 (the kernel then skips the products
whose lo parts are those of q, k or v). The emulation is this file's own;
the package holds only the kernel and its plain version.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref

TOL = 2e-5
NEG_INF = -1e30
BLOCK_K = 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32, to nearest with ties away from zero (the
    kernel's integer rounding, cvt.rna.tf32.f32 on finite x)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, terms: int) -> torch.Tensor:
    """a @ b^T in float32 from TF32 parts: 3 terms (the small ones first) or
    the high parts alone (terms=1)."""
    (ah, al), (bh, bl) = split(a), split(b)
    if terms == 1:
        return ah @ bh.transpose(-1, -2)
    return (al @ bh.transpose(-1, -2) + ah @ bl.transpose(-1, -2)
            + ah @ bh.transpose(-1, -2))


def emulate(q, k, v, *, causal=True, window=None, terms=3):
    """The tf32x3 kernel's arithmetic: q [B,H,Sq,D], k/v [B,K,Skv,D] float32
    -> [B,H,Sq,D]."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kh, dim=1)
    v = v.repeat_interleave(h // kh, dim=1)
    qs = q * (1.0 / math.sqrt(d))
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, skv, BLOCK_K):
        kt, vt = k[:, :, k0:k0 + BLOCK_K], v[:, :, k0:k0 + BLOCK_K]
        s = product(qs, kt, terms)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        mask = torch.ones_like(s, dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        # P V: p's parts against v's, as a product of p and v^T's rows
        o = o * corr + product(p, vt.transpose(-1, -2), terms)
        m = m_new
    return o / torch.clamp(l, min=1e-30)


def case(shape, seed, q_scale=1.0, v_scale=1.0):
    b, h, kh, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, h, sq, d)) * q_scale).astype(np.float32),
            rng.standard_normal((b, kh, skv, d)).astype(np.float32),
            (rng.standard_normal((b, kh, skv, d)) * v_scale).astype(
                np.float32))


def reference(q, k, v, causal, window, impl):
    return np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, impl=impl,
                              block_q=64, block_k=64))


def emulated(q, k, v, causal=True, window=None, terms=3):
    return emulate(*(torch.as_tensor(x) for x in (q, k, v)), causal=causal,
                   window=window, terms=terms).numpy()


# (b, h, kh, sq, skv, d): head dims 64, h2o-danube's 120 (not a multiple of
# 16), 128 and 36 (not a multiple of 8: the kernel's last k-step of Q K^T
# half zeros), GQA, queries shorter than keys; lengths multiples of the
# reference's 64-row blocks, which its interpret mode asserts
SHAPES = [(2, 4, 2, 128, 128, 64), (1, 4, 2, 128, 192, 120),
          (1, 2, 1, 64, 128, 128), (1, 4, 4, 128, 128, 36)]
MASKS = [(True, None), (True, 64), (False, None)]


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"d{s[-1]}")
@pytest.mark.parametrize("causal,window", MASKS)
def test_tf32x3_matches_reference(shape, causal, window, impl):
    q, k, v = case(shape, seed=shape[-1])
    want = reference(q, k, v, causal, window, impl)
    np.testing.assert_allclose(emulated(q, k, v, causal, window), want,
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", SHAPES[1:3], ids=lambda s: f"d{s[-1]}")
@pytest.mark.parametrize("causal,window", MASKS)
def test_tf32x3_holds_large_v(shape, causal, window):
    """v x 64: P V's products are in the tens, so p's split must hold. The
    bound is K7's with its atol scaled with |v| (2e-5 x 64; rtol 2e-5): a
    TF32 high part and the TF32 of its remainder carry 22 significant bits
    against float32's 24, so the split's absolute error grows with |v| (up
    to ~1.2x the unscaled bound where an output is near 0), while one TF32
    p misses by 2^-11 of |v|, ~20x the scaled atol."""
    q, k, v = case(shape, seed=7, v_scale=64.0)
    want = reference(q, k, v, causal, window, "ref")
    np.testing.assert_allclose(emulated(q, k, v, causal, window), want,
                               atol=TOL * 64.0, rtol=TOL)


def test_tf32x3_full_attention_with_more_queries_than_keys():
    """Cross-attention: neither causal nor windowed, Sq > Skv, ragged
    lengths (the last key tile short)."""
    q, k, v = case((1, 4, 2, 200, 130, 40), seed=40)
    want = np.asarray(jax.jit(lambda *a: j_flash_ref(*a, causal=False))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(emulated(q, k, v, causal=False), want,
                               atol=TOL, rtol=TOL)


def test_one_tf32_product_misses_the_tolerance():
    """At h2o-danube's head dim, products of TF32 high parts alone (about
    three decimal digits) miss 2e-5 where the three-term split holds."""
    q, k, v = case((1, 4, 2, 128, 192, 120), seed=120)
    want = reference(q, k, v, True, None, "ref")
    one = np.abs(emulated(q, k, v, terms=1) - want).max()
    three = np.abs(emulated(q, k, v, terms=3) - want).max()
    assert one > TOL > three, (one, three)


def test_bf16_inputs_split_with_zero_lo():
    """bf16 values (8 significant bits) are exact in TF32: hi is the value
    and lo is 0, so the kernel's products with q's, k's or v's lo parts add
    nothing for bf16 inputs."""
    rng = np.random.default_rng(16)
    x = torch.as_tensor(rng.standard_normal(4096).astype(np.float32) * 100)
    x = x.to(torch.bfloat16).to(torch.float32)
    hi, lo = split(x)
    assert torch.equal(hi, x) and not lo.any()


def test_tf32_rounding():
    """The integer rounding keeps 10 fraction bits, rounds to nearest, ties
    away from zero (cvt.rna), and the remainder is exact: hi + lo holds x
    to 2^-22 relative."""
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11])
    assert tf32(one).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                                  1.0 + 2.0 ** -9]
    rng = np.random.default_rng(32)
    x = torch.as_tensor(rng.standard_normal(1 << 16).astype(np.float32))
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= x.abs().double() * 2.0 ** -22).all())
