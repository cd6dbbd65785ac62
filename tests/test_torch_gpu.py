"""The hand-written CUDA kernels held against their plain torch versions on
the card (marker ``gpu``; skips without a CUDA device).

This file imports neither jax nor the reference package, so it also runs on
a machine that has only torch. On the card:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports jax). The seeded
cases here also feed ``tests/test_torch_kernels.py``, which holds the plain
versions against the reference on the CPU: for the selection core, ties
from integer scores, +-inf and NaN scores, zero and negative quotas, k > S,
ring overflow and a ring head near 2**31; for the serving kernels, free
slots, mid-page lengths, a sliding window, an all-unselected page move and
a move whose source and destination slots are equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.migrate import ops as TMIG
from repro_torch.kernels.migrate import ref as TMIG_REF
from repro_torch.kernels.select import ops as TSEL
from repro_torch.kernels.select import ref as TSEL_REF


def topk_case(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.choice([1, 4, 9]))
    S = int(rng.choice([1, 7, 64, 130]))
    if seed % 2 == 0:       # integer scores force tie-break agreement
        score = rng.integers(-4, 4, (T, S)).astype(np.float32)
    else:
        score = rng.standard_normal((T, S)).astype(np.float32)
    u = rng.random((T, S))
    score[u < 0.05] = -np.inf
    score[(u >= 0.05) & (u < 0.1)] = np.inf
    score[(u >= 0.1) & (u < 0.13)] = np.nan
    valid = rng.random((T, S)) < rng.choice([0.3, 0.8, 1.0])
    quotas = rng.integers(-3, S + 3, T).astype(np.int32)
    quotas[rng.integers(0, T)] = 0
    k = int(rng.choice([1, 5, S + 2]))      # S + 2: k > S
    return score, valid, quotas, k


def moves_case(seed):
    rng = np.random.default_rng(200 + seed)
    L = int(rng.choice([8, 48]))
    C = int(rng.choice([1, 4, 8]))
    N = int(rng.choice([1, 16, 33]))
    tier = rng.integers(0, 2, L).astype(np.int32)
    data = rng.integers(-5, 5, (C, 5)).astype(np.int32)
    if seed % 2:           # head near 2**31: the slot sum wraps
        head = np.int32(2**31 - 1 - int(rng.integers(0, 3 * C)))
    else:
        head = np.int32(rng.integers(0, 3 * C))
    take = rng.random(N) < 0.6
    # sentinel L on untaken lanes; a page taken twice stores the same tier
    pages = np.where(take, rng.integers(0, L, N), L).astype(np.int32)
    tenants = rng.integers(0, 7, N).astype(np.int32)
    hot = rng.standard_normal(N).astype(np.float32)
    t = int(rng.integers(0, 100))
    direction = int(rng.integers(0, 2))
    to_tier = int(rng.integers(0, 2))
    return tier, data, head, pages, take, tenants, hot, t, direction, to_tier


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(8))
def test_kernels_match_plain_on_card(seed, cuda):
    """Every kernel bitwise equal to its plain version on the same inputs
    (a small, fast subset of chip_smoke.py's phase 2)."""
    score, valid, quotas, k = topk_case(seed)
    args = [torch.as_tensor(a, device=cuda) for a in (score, valid, quotas)]
    kk = max(min(k, score.shape[1]), 1)
    for g, w in zip(TSEL.seg_topk(*args, k), TSEL_REF.seg_topk_ref(*args, kk)):
        assert torch.equal(g, w)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(-2**31, 2**31, (5, 3000), dtype=np.int64)
                        .astype(np.int32), device=cuda)
    v = torch.as_tensor(rng.random((5, 3000)) < 0.5, device=cuda)
    for g, w in zip(TSEL.seg_reduce(x, v), TSEL_REF.seg_reduce_ref(x, v)):
        assert torch.equal(g, w)
    assert torch.equal(TSEL.seg_sums(x, v), TSEL_REF.seg_sums_ref(x, v))
    (tier, data, head, pages, take, tenants, hot, t, direction,
     to_tier) = moves_case(seed)
    a = [torch.as_tensor(z, device=cuda)
         for z in (tier, data, head, pages, take, tenants)]
    h = torch.as_tensor(hot, device=cuda)
    want = TMIG_REF.commit_moves_ref(*[z.clone() for z in a],
                                     h.view(torch.int32), t,
                                     direction=direction, to_tier=to_tier)
    got = TMIG.commit_moves(*a, h, t, direction=direction, to_tier=to_tier)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


# --------------------------------------------- serving kernels (K5, K6) ----
# (b, h, kh, d, mf, ms, pt): the reference's tests/test_kernels.py shapes
ATTN_SHAPES = [(2, 8, 4, 64, 16, 8, 8), (3, 4, 4, 32, 8, 8, 4),
               (2, 16, 2, 64, 16, 16, 8)]


def attention_case(shape, seed=0, dtype=np.float32):
    """Seeded tiered-attention inputs in the reference's layout: the last
    two fast slots and the last slow slot free, seq_len three tokens short
    of the end of the last page (mid-page)."""
    b, h, kh, d, mf, ms, pt = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(dtype)
    fk, fv = (rng.standard_normal((b, mf, pt, kh, d)).astype(dtype)
              for _ in range(2))
    sk, sv = (rng.standard_normal((b, ms, pt, kh, d)).astype(dtype)
              for _ in range(2))
    fp = np.where(np.arange(mf)[None] < mf - 2,
                  np.arange(mf)[None].repeat(b, 0), -1).astype(np.int32)
    sp = np.where(np.arange(ms)[None] < ms - 1,
                  (mf - 2 + np.arange(ms))[None].repeat(b, 0), -1
                  ).astype(np.int32)
    seq_len = np.full((b,), (mf - 2 + ms - 1) * pt - 3, np.int32)
    return q, fk, fv, sk, sv, fp, sp, seq_len


def migrate_case(shape, seed=0):
    """Seeded page-move inputs: pools [L, B, M, pt, K, D] in float32, and
    index/selection vectors with both selected and unselected sequences."""
    l, b, msrc, mdst, pt, kh, d = shape
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((l, b, msrc, pt, kh, d)).astype(np.float32)
    dst = rng.standard_normal((l, b, mdst, pt, kh, d)).astype(np.float32)
    si = rng.integers(0, msrc, b).astype(np.int32)
    di = rng.integers(0, mdst, b).astype(np.int32)
    sel = rng.integers(0, 2, b).astype(bool)
    return src, dst, si, di, sel


# (l, b, msrc, mdst, pt, kh, d): the reference's tests/test_kernels.py shapes
MIGRATE_SHAPES = [(2, 4, 6, 5, 4, 2, 16), (1, 8, 4, 4, 8, 1, 32),
                  (3, 2, 8, 8, 2, 4, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(64, 32, 8, 64, 32, 16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
def test_pool_attention_matches_plain_on_card(shape, dtype, window, cuda):
    """K5 against its plain version on the same inputs; float32 sums in
    another order, so atol/rtol 1e-4 (the bf16 pools are read exactly)."""
    from repro_torch.kernels.tiered_attention import ops as TA
    from repro_torch.kernels.tiered_attention import ref as TA_REF
    q, fk, fv, sk, sv, fp, sp, seq_len = (
        torch.as_tensor(a, device=cuda) for a in attention_case(shape))
    fk, fv, sk, sv, q = (x.to(dtype) for x in (fk, fv, sk, sv, q))
    for pk, pv, page in ((fk, fv, fp), (sk, sv, sp)):
        got = TA.pool_attention_partial(q[:, 0], pk, pv, page, seq_len,
                                        window=window)
        want = TA_REF.pool_attention_partial_ref(q[:, 0], pk, pv, page,
                                                 seq_len, window=window)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MIGRATE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_migrate_pages_matches_plain_on_card(shape, dtype, cuda):
    """K6 bitwise against its plain version, including an all-unselected
    ``sel`` and source slot == destination slot."""
    from repro_torch.kernels.migrate import ops as TMIG
    from repro_torch.kernels.migrate import ref as TMIG_REF
    src, dst, si, di, sel = migrate_case(shape)
    same = np.minimum(si, min(src.shape[2], dst.shape[2]) - 1)
    for s_i, d_i, se in ((si, di, sel), (same, same, sel),
                         (si, di, np.zeros_like(sel))):
        a = [torch.as_tensor(x, device=cuda) for x in (s_i, d_i, se)]
        s_t = torch.as_tensor(src, device=cuda).to(dtype)
        want = TMIG_REF.migrate_pages_ref(
            s_t, torch.as_tensor(dst, device=cuda).to(dtype), *a)
        got = TMIG.migrate_pages(
            s_t, torch.as_tensor(dst, device=cuda).to(dtype), *a)
        assert torch.equal(got, want)
    torch.cuda.synchronize()
