"""Counter-based random draws in torch integer ops, bit for bit with
``jax.random`` under its default threefry2x32 implementation and
``jax_threefry_partitionable=True`` (the default since jax 0.5).

The sketch hotness provider draws its probe lanes with
``randint(fold_in(PRNGKey(seed), t), (T, r), 0, S)`` (reference
``core/hotness.py:288-289``). Because the draw is a pure function of
(seed, t), the same lanes come out on any device. Words are uint32 held in
int64 tensors and masked after every add, multiply and shift.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k0: int, k1: int, x0, x1):
    """The 20-round Threefry-2x32 block of key (k0, k1) over counter words
    (x0, x1): Python ints, or int64 tensors holding uint32 values."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for d in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, d) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for an int32 seed: (hi, lo) words."""
    return (0, seed & _M32)


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``: the block of ``key`` over the
    counter (0, data)."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def split2(key):
    """``jax.random.split(key, 2)`` (partitionable): blocks over counters
    (0, 0) and (0, 1)."""
    return (threefry2x32(key[0], key[1], 0, 0),
            threefry2x32(key[0], key[1], 0, 1))


def random_bits(key, shape, device) -> torch.Tensor:
    """32 random bits per element (partitionable): the block of ``key``
    over the element's flat index (hi, lo), its two words xor-ed.
    Returns an int64 tensor of uint32 values."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return (y0 ^ y1).reshape(shape)


def randint(key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``: two
    32-bit draws combined modulo the span, as jax does (the draw is biased
    when the span is not a power of two, exactly as jax's). int32 result.
    The span must be below 2**31."""
    span = maxval - minval if maxval > minval else 1
    if not 0 < span < 2 ** 31:
        raise ValueError(f"randint span {span} out of range")
    k_hi, k_lo = split2(key)
    hi = random_bits(k_hi, shape, device)
    lo = random_bits(k_lo, shape, device)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span      # a uint32 product, as in jax
    off = ((hi % span) * mult) & _M32
    off = ((off + lo % span) & _M32) % span
    return (off + minval).to(torch.int32)
