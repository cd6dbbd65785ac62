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
a move whose source and destination slots are equal; for the prefill
kernels (whose seeded cases also feed ``tests/test_torch_prefill.py``),
causal / windowed / full attention with GQA, ragged lengths and queries
shorter than keys, and SSD scans under decays that underflow.
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


# seg_topk's edge cases (the same kinds as chip_smoke.py's phase 2): rows
# longer than the kernel stages in shared memory (S > 24,576), more winners
# than it sorts at once (r > 2,048), rows with nothing eligible, rows that
# tie throughout (with -0.0 against +0.0), quotas around 0 and k, and the
# dynamic path's rowspace (S = L, each row's valid lanes a prefix of its
# tenant's pages, cold pages scoring 0.0)
TOPK_EDGE_CASES = ("long_row", "long_row_over_sort_cap", "over_sort_cap",
                   "all_nan", "all_invalid", "all_tied", "quota_grid",
                   "dynamic_rowspace")


def topk_edge_case(name):
    """(score, valid, quotas, k) of edge case ``name``, seeded."""
    rng = np.random.default_rng(TOPK_EDGE_CASES.index(name))

    def mixed(T, S):
        score = rng.standard_normal((T, S)).astype(np.float32)
        score[::2] = rng.integers(-20, 20, score[::2].shape)   # ties
        u = rng.random((T, S))
        score[u < 0.02] = np.inf
        score[(u >= 0.02) & (u < 0.04)] = -np.inf
        score[(u >= 0.04) & (u < 0.06)] = np.nan
        return score, rng.random((T, S)) < 0.6

    if name == "long_row":
        score, valid = mixed(1, 262144)
        return score, valid, np.array([256], np.int32), 256
    if name == "long_row_over_sort_cap":
        score, valid = mixed(1, 262144)
        return score, valid, np.array([3000], np.int32), 3000
    if name == "over_sort_cap":
        score, valid = mixed(3, 8192)
        return score, valid, np.array([5000, 2049, 4097], np.int32), 5000
    if name == "all_nan":
        score = np.full((2, 1000), np.nan, np.float32)
        return score, np.ones_like(score, bool), np.array([5, 1000],
                                                          np.int32), 300
    if name == "all_invalid":
        score = rng.standard_normal((2, 1000)).astype(np.float32)
        return score, np.zeros_like(score, bool), np.array([5, 1000],
                                                           np.int32), 300
    if name == "dynamic_rowspace":
        # 4 rows of S=262,144, about 1,250 valid lanes each from column 0,
        # a third of the scores 0.0 (some -0.0); row 1 has five non-zero
        # scores, so its winners run into the tie at 0.0
        T, S = 4, 262144
        score = (rng.random((T, S)) * 4).astype(np.float32)
        u = rng.random((T, S))
        score[u < 1 / 3] = 0.0
        score[u < 1 / 30] = -0.0
        score[1, 5:] = 0.0
        valid = np.arange(S)[None, :] < rng.integers(1150, 1350, T)[:, None]
        return score, valid, np.array([0, 19, 7, 19], np.int32), 256
    k = 2500 if name == "all_tied" else 256
    quotas = np.array([-1, 0, 1, k, k + 40], np.int32)
    if name == "all_tied":
        score = np.full((5, 3000), 2.5, np.float32)
        score[1] = np.where(rng.random(3000) < 0.5, -0.0, 0.0)
        return score, np.ones_like(score, bool), quotas, k
    score, valid = mixed(5, 4096)              # quota_grid
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


# K3 (seg_sums) at shapes the seeded grid never reaches: C1's full width,
# rows whose start is not 16-byte aligned (S % 4 != 0, S % 16 != 0 for the
# valid bytes), a single lane, a single row, a long row and more rows than
# the card has SMs; "offset" places x one element past an aligned start
# (x and valid out of phase: the kernel's lane-by-lane path)
SUMS_CARD_SHAPES = [(64, 4096), (64, 4097), (64, 4093), (64, 1), (1, 4096),
                    (1, 262144), (200, 4096), (7, 3000)]


def sums_card_case(shape, values):
    """(x int32, valid bool) of ``shape``: 0/1 values (what the tick feeds)
    or full-range values whose sums wrap."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    if values == "mask":
        x = rng.integers(0, 2, shape).astype(np.int32)
    else:
        x = rng.integers(-2**31, 2**31, shape, dtype=np.int64
                         ).astype(np.int32)
    return x, rng.random(shape) < 0.7


# K4 (commit_moves) at shapes the seeded grid never reaches:
# name -> (N, C, share of lanes taken, head). C1's stream (N = 16,384,
# C = 4,096) with more and fewer taken lanes than the ring holds, N one off
# the 16-lane run either way, N past one block's 1,024 runs of 16, heads
# within 3C of 2**31 - 1 (the slot sum wraps), and a one-slot ring
MOVES_CARD_CASES = {
    "c1_over_ring": (16384, 4096, 0.5, 7),
    "c1_under_ring": (16384, 4096, 0.1, 7),
    "c1_settled": (16384, 4096, 0.0, 7),
    "n16383": (16383, 4096, 0.5, 2**31 - 1 - 5000),
    "n16385": (16385, 4096, 0.5, 2**31 - 1 - 11000),
    "n131072": (131072, 4096, 0.3, 2**31 - 1 - 40),
    "head_near_max": (16384, 4096, 0.4, 2**31 - 1),
    "ring_of_one": (16384, 1, 0.5, 2**31 - 2),
}


def moves_card_case(name):
    """moves_case's tuple at MOVES_CARD_CASES[name]: distinct pages of
    L = 262,144 on the taken lanes, the sentinel L on the rest."""
    N, C, p_take, head = MOVES_CARD_CASES[name]
    rng = np.random.default_rng(300 + list(MOVES_CARD_CASES).index(name))
    L = 262144
    tier = rng.integers(0, 2, L).astype(np.int32)
    data = rng.integers(-5, 5, (C, 5)).astype(np.int32)
    take = rng.random(N) < p_take
    pages = np.where(take, rng.permutation(L)[:N], L).astype(np.int32)
    tenants = rng.integers(0, 64, N).astype(np.int32)
    hot = rng.standard_normal(N).astype(np.float32)
    return (tier, data, np.int32(head), pages, take, tenants, hot, 11, 1, 0)


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


@pytest.mark.gpu
@pytest.mark.parametrize("name", TOPK_EDGE_CASES)
def test_seg_topk_edge_cases_match_plain_on_card(name, cuda):
    """K1 bitwise against its plain version on rows past the shared-memory
    staging, winners past the in-shared-memory sort, rows with nothing
    eligible, all-tied rows and quotas -1, 0, 1, k and k + 40."""
    score, valid, quotas, k = topk_edge_case(name)
    args = [torch.as_tensor(a, device=cuda) for a in (score, valid, quotas)]
    got = TSEL.seg_topk(*args, k)
    want = TSEL_REF.seg_topk_ref(*args, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


# (T, S, route, (score offset, valid offset) in elements, share of valid
# lanes): rows up to S = 24,576 on the staged route (C1's S=4,096), longer
# ones on the long route; views at offsets 1 and 1 keep score and valid in
# phase (single lanes before the first 16-byte unit), 1 and 3 put them out
# of phase (every lane of the row one at a time); 2% valid keeps a block's
# eligible keys staged in shared memory, 60% overflows the stage and the
# candidate buffer (further digits over the row again)
TOPK_ROUTE_CASES = [(64, 4096, "staged", (0, 0), 0.02),
                    (2, 24576, "staged", (0, 0), 0.02),
                    (2, 24577, "long", (0, 0), 0.02),
                    (64, 261824, "long", (0, 0), 0.02),
                    (1, 262144, "long", (0, 0), 0.02),
                    (2, 262144, "long", (1, 1), 0.6),
                    (2, 262144, "long", (1, 3), 0.02),
                    (2, 262144, "long", (1, 3), 0.6)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,S,route,offsets,p_valid", TOPK_ROUTE_CASES)
def test_seg_topk_route_on_card(T, S, route, offsets, p_valid, cuda):
    """K1's launcher takes the staged route up to S = 24,576 (C1's
    S=4,096) and the cluster route past it (the dynamic rowspace, S = L),
    as ``seg_topk.routes`` counts, bitwise equal to the plain version, with
    score and valid as views at offsets in phase and out of phase."""
    rng = np.random.default_rng(S)
    score, valid = (rng.random((T, S)) * 4).astype(np.float32), \
        rng.random((T, S)) < p_valid
    quotas = rng.integers(0, 300, T).astype(np.int32)
    args = [_at_offset(score, cuda, offsets[0]),
            _at_offset(valid, cuda, offsets[1]),
            torch.as_tensor(quotas, device=cuda)]
    before = dict(TSEL.seg_topk.routes)
    got = TSEL.seg_topk(*args, 256)
    delta = {r: n - before[r] for r, n in TSEL.seg_topk.routes.items()}
    assert delta == {r: int(r == route) for r in delta}
    for g, w in zip(got, TSEL_REF.seg_topk_ref(*args, 256)):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


def _at_offset(a, device, offset: int) -> torch.Tensor:
    """``a`` (an array or a tensor) on ``device`` as a contiguous view
    ``offset`` elements into a larger buffer (its data pointer is then not
    16-byte aligned)."""
    t = torch.as_tensor(a, device=device)
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=device)
    flat[offset:] = t.reshape(-1)
    return flat[offset:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SUMS_CARD_SHAPES)
@pytest.mark.parametrize("values", ["mask", "full"])
@pytest.mark.parametrize("offset", [0, 1])
def test_seg_sums_matches_plain_on_card(shape, values, offset, cuda):
    """K3 bitwise against its plain version at C1's width, on unaligned
    rows, S=1, T=1, a long row, T=200 and x out of phase with valid."""
    x, valid = sums_card_case(shape, values)
    xt = _at_offset(x, cuda, offset)
    vt = torch.as_tensor(valid, device=cuda)
    assert torch.equal(TSEL.seg_sums(xt, vt), TSEL_REF.seg_sums_ref(xt, vt))
    torch.cuda.synchronize()


# (x offset, valid offset) in elements: aligned alike, both one element in
# (in phase, three lanes before the first 16-byte unit), and each alone
# (out of phase: the lane-by-lane path)
REDUCE_OFFSETS = [(0, 0), (1, 1), (1, 0), (0, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SUMS_CARD_SHAPES)
@pytest.mark.parametrize("values", ["mask", "full"])
@pytest.mark.parametrize("offsets", REDUCE_OFFSETS)
def test_seg_reduce_matches_plain_on_card(shape, values, offsets, cuda):
    """K2 (sums and exclusive prefix) bitwise against its plain version at
    K3's card shapes, with x and valid as views at odd offsets."""
    x, valid = sums_card_case(shape, values)
    xt = _at_offset(x, cuda, offsets[0])
    vt = _at_offset(valid, cuda, offsets[1])
    for g, w in zip(TSEL.seg_reduce(xt, vt), TSEL_REF.seg_reduce_ref(xt, vt)):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(MOVES_CARD_CASES))
@pytest.mark.parametrize("offset", [0, 1])
def test_commit_moves_matches_plain_on_card(name, offset, cuda):
    """K4 bitwise against its plain version on C1's stream with the ring
    over- and under-filled and nothing taken, N = 16,383 and 16,385,
    N = 131,072, heads near 2**31 - 1 and C = 1; offset 1 puts the stream
    at unaligned addresses (the lane-by-lane path)."""
    (tier, data, head, pages, take, tenants, hot, t, direction,
     to_tier) = moves_card_case(name)
    a = [torch.as_tensor(z, device=cuda) for z in (tier, data, head)]
    stream = [_at_offset(z, cuda, offset) for z in (pages, take, tenants)]
    h = _at_offset(hot, cuda, offset)
    want = TMIG_REF.commit_moves_ref(*[z.clone() for z in a + stream],
                                     h.view(torch.int32), t,
                                     direction=direction, to_tier=to_tier)
    got = TMIG.commit_moves(*a, *stream, h, t, direction=direction,
                            to_tier=to_tier)
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
# K6 at shapes the reference's never reach: pages whose size is not a
# multiple of 16 bytes (15 and 42 elements), a page of one 16 KiB chunk
# and a part (4,800 f32), more sequences than one block compacts at once
# (300), and S1's and S3's pages (16 tokens of 8 x 64 and of 32 x 112:
# one and seven 16 KiB chunks in bf16) at a cut depth and batch
MIGRATE_ODD_SHAPES = [(2, 5, 4, 3, 3, 1, 5), (3, 4, 3, 3, 2, 3, 7),
                      (2, 4, 3, 3, 16, 3, 100), (1, 300, 3, 4, 2, 2, 8)]
MIGRATE_CARD_SHAPES = [(2, 16, 8, 6, 16, 8, 64), (2, 8, 6, 5, 16, 32, 112)]


def migrate_index_cases(si, di, sel, msrc, mdst):
    """(src_idx, dst_idx, sel) triples for one pool pair: the seeded
    indices, source slot == destination slot, nothing selected, and
    indices out of the pools on both sides (negative and past the end;
    the kernels clamp them)."""
    same = np.minimum(si, min(msrc, mdst) - 1)
    oob_s = si.copy()
    oob_d = di.copy()
    oob_s[0::3] = -3
    oob_s[1::3] = msrc + 2
    oob_d[0::2] = mdst + 5
    oob_d[1::2] = -1
    return {"seeded": (si, di, sel), "same_slot": (same, same, sel),
            "none": (si, di, np.zeros_like(sel)),
            "out_of_range": (oob_s, oob_d, np.ones_like(sel))}


# K5's card shapes beyond the reference's: S1's (Llama 3.2 1B: 64
# sequences, 32 heads on 8 kv heads of 64, 32 fast and 16 slow slots of 16
# tokens), S3's (Zamba2-7B: 32 sequences, 32 heads of 112 with G = 1, 16
# slots each), a small batch whose pools the launcher splits (16 and 10
# splits) and pages of 32 tokens (two of a warp's 16-token units) with
# G = 4
K5_CARD_SHAPES = [(64, 32, 8, 64, 32, 16, 16), (32, 32, 32, 112, 16, 16, 16),
                  (1, 32, 8, 64, 64, 40, 16), (2, 8, 2, 64, 8, 6, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ATTN_SHAPES + K5_CARD_SHAPES)
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
@pytest.mark.parametrize("shape", MIGRATE_SHAPES + MIGRATE_ODD_SHAPES
                         + MIGRATE_CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_migrate_pages_matches_plain_on_card(shape, dtype, offset, cuda):
    """K6 bitwise against its plain version, one pool pair and a K+V pair
    in one launch, in place: an all-unselected ``sel``, source slot ==
    destination slot, indices out of range, page sizes not a multiple of
    16 bytes, S1's and S3's pages, and pools at unaligned addresses."""
    from repro_torch.kernels.migrate import ops as TMIG
    from repro_torch.kernels.migrate import ref as TMIG_REF
    src, dst, si, di, sel = migrate_case(shape)
    v_src, v_dst = (a[::-1].copy() for a in (src, dst))
    pools = [_at_offset(torch.as_tensor(a).to(dtype), cuda, offset)
             for a in (src, dst, v_src, v_dst)]
    for s_i, d_i, se in migrate_index_cases(si, di, sel, shape[2],
                                            shape[3]).values():
        a = [torch.as_tensor(x, device=cuda) for x in (s_i, d_i, se)]
        want = TMIG_REF.migrate_pages_ref(pools[0], pools[1].clone(), *a)
        got_dst = pools[1].clone()
        got = TMIG.migrate_pages(pools[0], got_dst, *a)
        assert got is got_dst and torch.equal(got, want)
        want_kv = TMIG_REF.migrate_pages_kv_ref(
            pools[0], pools[1].clone(), pools[2], pools[3].clone(), *a)
        got_kv = TMIG.migrate_pages_kv(pools[0], pools[1].clone(), pools[2],
                                       pools[3].clone(), *a)
        for g, w in zip(got_kv, want_kv):
            assert torch.equal(g, w)
    torch.cuda.synchronize()


# --------------------------------------------- prefill kernels (K7, K8) ----
# (b, h, kh, sq, skv, d): the reference's tests/test_kernels.py shapes, then
# the port's widths (zamba2's head dim 112; lengths not a multiple of the
# 64-row tiles, queries shorter than keys; head dims of 40 and h2o-danube's
# 120, not multiples of 16, which bf16 runs on the wgmma kernel with a last
# k-step that reads the TMA's zeros past D)
FLASH_SHAPES = [(2, 4, 2, 128, 128, 64), (1, 8, 8, 64, 64, 32),
                (2, 2, 1, 64, 256, 64), (1, 4, 2, 256, 256, 48),
                (1, 4, 4, 128, 128, 112), (1, 4, 2, 200, 200, 112),
                (2, 4, 2, 72, 200, 64), (1, 4, 2, 96, 96, 40),
                (1, 4, 2, 200, 200, 120)]
FLASH_MASKS = [(True, None), (True, 64), (False, None)]


def flash_case(shape, seed=0):
    """Seeded q [B,H,Sq,D], k/v [B,K,Skv,D] in float32."""
    b, h, kh, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kh, skv, d)).astype(np.float32),
            rng.standard_normal((b, kh, skv, d)).astype(np.float32))


# (b, s, h, p, n, chunk, g): the reference's tests/test_kernels.py shapes
# (groups == heads), then a chunk of 64 with grouped B/C
SSD_SHAPES = [(2, 64, 3, 16, 8, 16, 3), (1, 128, 2, 32, 16, 32, 2),
              (2, 32, 4, 8, 8, 8, 4), (1, 256, 4, 16, 16, 64, 1)]


def ssd_case(shape, seed=0, decay="test"):
    """Seeded SSD inputs: x [B,S,H,P], a [B,S,H], b/c [B,S,G,N] float32.
    ``decay`` "test" is the reference test's ``-|N(0,1)| * 0.3``; "init" is
    what the reference's init gives a Mamba2 block, softplus(~N(0, 1.2)) *
    -1 (about -0.69 a step, so exp(a_cum) underflows inside a chunk of
    256); "strong" is -|N(0,1)| * 8."""
    b, s, h, p, n, _, g = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    z = rng.standard_normal((b, s, h))
    a = {"test": -np.abs(z) * 0.3,
         "init": -np.logaddexp(z * 1.2, 0.0),
         "strong": -np.abs(z) * 8.0}[decay].astype(np.float32)
    bb = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cc = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, a, bb, cc


def _routed(FA, fn):
    """(fn's result, the K7 launches it made by route)."""
    before = dict(FA.flash_attention.routes)
    out = fn()
    return out, {r: n - before[r] for r, n in FA.flash_attention.routes.items()}


# the tf32x3 kernel's own grid, f32: head dims 36 and 100 (not multiples of
# 8 or 16: Q K^T's last k-step half zeros, P V at the template width with
# V^T's rows past D zero), 128 and h2o-danube's 120 at its GQA; lengths
# that are not multiples of the 64-row and 64-key tiles; q x 8 (scores in
# the tens: the split of S must hold) and v x 64 (the split of p must hold)
TF32X3_SHAPES = [(1, 4, 2, 200, 200, 36), (2, 4, 1, 130, 257, 100),
                 (1, 4, 4, 192, 192, 128), (1, 32, 8, 300, 300, 120)]
# (shape, dtype, q scale, v scale, seed): the reference's shapes in both
# dtypes, then the tf32x3 grid
FLASH_CASES = (
    [(s, dt, 1.0, 1.0, 0) for s in FLASH_SHAPES
     for dt in (torch.float32, torch.bfloat16)]
    + [(s, torch.float32, qs, vs, s[-1]) for s in TF32X3_SHAPES
       for qs, vs in ((1.0, 1.0), (8.0, 1.0), (1.0, 64.0))])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,q_scale,v_scale,seed", FLASH_CASES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_matches_plain_on_card(shape, dtype, q_scale,
                                               v_scale, seed, causal, window,
                                               cuda):
    """K7 against its plain version on the same inputs, within the
    reference's kernel tolerance (tests/test_kernels.py: 2e-5 in float32,
    2e-2 in bf16); f32 on the tf32x3 kernel (one TF32 product misses 2e-5),
    its atol scaled with |v| for v x 64 (the split carries 22 significant
    bits against float32's 24, so its absolute error grows with |v|; one
    TF32 p would miss ~20x), bf16 on the wgmma kernel, as the launcher
    reports; strided [B, S, H, D] views of q, k and v give a bitwise equal
    output."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    q, k, v = flash_case(shape, seed=seed)
    q, k, v = (torch.as_tensor(x, device=cuda).to(dtype)
               for x in (q * q_scale, k, v * v_scale))
    got, routes = _routed(FA, lambda: FA.flash_attention(
        q, k, v, causal=causal, window=window))
    route = "tf32x3" if dtype == torch.float32 else "wgmma"
    assert routes == {r: int(r == route) for r in routes}
    want = FA_REF.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    atol = tol * v_scale if dtype == torch.float32 else tol
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=tol)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    assert torch.equal(FA.flash_attention(*views, causal=causal,
                                          window=window), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_keeps_p_exact_with_large_values_on_card(
        causal, window, cuda):
    """bf16 K7 with |v| in the tens (as in a prefill's first layer) within
    2e-2 of its plain version: the tensor-core kernel's P V must keep p
    near float32, as the TPU kernel's float32 product does; one bf16 p
    misses by up to 2^-9 of |v|."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    q, k, v = flash_case((1, 4, 2, 256, 256, 64), seed=3)
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16)
               for x in (q, k, v * 64))
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA_REF.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.cuda.synchronize()


# the tensor-core kernel's grid: head dims 64, 112 and 120 (two TMA boxes,
# the second clipped; 120 takes 8 k-steps, the last half zeros) and 128;
# groups of 1 and 4 query heads per kv head;
# lengths that are not multiples of its 128-row tiles, queries shorter than
# keys; v scaled by 64 (|v| in the tens, as in a prefill's first layer)
WGMMA_DIMS = [64, 112, 120, 128]
WGMMA_LENGTHS = [(200, 200), (72, 333), (256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", WGMMA_DIMS)
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sq,skv", WGMMA_LENGTHS)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("v_scale", [1.0, 64.0])
def test_flash_attention_wgmma_grid_matches_plain_on_card(
        d, g, sq, skv, causal, window, v_scale, cuda):
    """bf16 K7 (the wgmma kernel) within 2e-2 of its plain version over
    head dims, GQA groups, ragged lengths, masks and large values; strided
    [B, S, H, D] views of q, k and v read the same."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    q, k, v = flash_case((2, 2 * g, 2, sq, skv, d), seed=d + g)
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16)
               for x in (q, k, v * v_scale))
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA_REF.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    assert torch.equal(FA.flash_attention(*views, causal=causal,
                                          window=window), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_d120_takes_wgmma_on_card(causal, window, cuda):
    """h2o-danube's heads (H=32, K=8, D=120) at S=1,024 in bf16, read as
    [B, H, S, D] views of its [B, S, H, D] activations: the launcher
    reports the wgmma kernel, the output is within 2e-2 of the plain
    version and equal to the contiguous inputs' result."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16)
               for x in flash_case((1, 32, 8, 1024, 1024, 120), seed=120))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    assert views[0].stride() == (1024 * 32 * 120, 120, 32 * 120, 1)
    got, routes = _routed(FA, lambda: FA.flash_attention(
        *views, causal=causal, window=window))
    assert routes == {"wgmma": 1, "tf32x3": 0}
    want = FA_REF.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(FA.flash_attention(q, k, v, causal=causal,
                                          window=window), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_unaligned_bf16_takes_tf32x3_on_card(
        causal, window, cuda):
    """bf16 views whose bases are not 16-byte aligned (columns 1-40 of a
    D=48 tensor) are refused by the TMA: the launcher reports the tf32x3
    kernel, which reads them with element loads (their lo parts are 0) and
    whose output is within 2e-2 of the plain version."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16)[..., 1:41]
               for x in flash_case((1, 4, 2, 200, 200, 48), seed=48))
    assert q.data_ptr() % 16 == 2 and q.stride(-1) == 1
    got, routes = _routed(FA, lambda: FA.flash_attention(
        q, k, v, causal=causal, window=window))
    assert routes == {"wgmma": 0, "tf32x3": 1}
    want = FA_REF.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_tf32x3_key_order_on_card(causal, window, cuda):
    """The tf32x3 kernel stores V^T's keys permuted in each group of 8 so
    that the S registers feed the A operand as they are. A V whose entries
    all differ (v[key, d] distinct over keys and columns) and scores so
    peaked (q x 16) that each row reads a few keys: a key taken for its
    neighbour would show as an error of order 1, far past 2e-5."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    q, k, _ = flash_case((1, 4, 2, 256, 256, 64), seed=64)
    key = np.arange(256, dtype=np.float32)[:, None]
    col = np.arange(64, dtype=np.float32)[None, :]
    v = np.broadcast_to((key * 64 + col) / 16384.0, (1, 2, 256, 64))
    q, k, v = (torch.as_tensor(np.ascontiguousarray(x), device=cuda)
               for x in (q * 16, k, v))
    got, routes = _routed(FA, lambda: FA.flash_attention(
        q, k, v, causal=causal, window=window))
    assert routes == {"wgmma": 0, "tf32x3": 1}
    want = FA_REF.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    torch.cuda.synchronize()


# cross-attention: full (neither causal nor windowed) attention with more
# queries than keys, at the encoder's and the image's ragged key counts
# (1,500 frames, 1,600 image tokens): whisper's heads (H = K = 6, D = 64)
# and the vlm's (G = 8, D = 128), then a head dim of 40, not a multiple of
# 16 (bf16 on the wgmma kernel, its last k-step half the TMA's zeros)
FLASH_CROSS_SHAPES = [(2, 6, 6, 2048, 1500, 64), (1, 16, 2, 2100, 1600, 128),
                      (1, 4, 2, 1700, 1500, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FLASH_CROSS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v_scale", [1.0, 64.0])
def test_flash_attention_cross_matches_plain_on_card(shape, dtype, v_scale,
                                                     cuda):
    """Non-causal K7 with Sq > Skv (the right-aligned query offset Skv - Sq
    negative, read by no mask) within the reference's kernel tolerance of
    its plain version; strided [B, S, H, D] views read the same."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    q, k, v = flash_case(shape, seed=shape[4])
    q, k, v = (torch.as_tensor(x, device=cuda).to(dtype)
               for x in (q, k, v * v_scale))
    before = FA.flash_attention.launches
    got, routes = _routed(FA, lambda: FA.flash_attention(q, k, v,
                                                         causal=False))
    assert FA.flash_attention.launches == before + 1
    route = "tf32x3" if dtype == torch.float32 else "wgmma"
    assert routes == {r: int(r == route) for r in routes}
    want = FA_REF.flash_attention_ref(q, k, v, causal=False)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    assert torch.equal(FA.flash_attention(*views, causal=False), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_refuses_masked_sq_over_skv_on_card(causal, window,
                                                            dtype, cuda):
    """With a causal or window mask, Sq > Skv stays refused: by the
    wrapper, and by the launcher itself when the wrapper is bypassed."""
    import ctypes
    from repro_torch.kernels.build import load_library, stream_of
    from repro_torch.kernels.flash_attention import kernel as FK
    q, k, v = (torch.as_tensor(x, device=cuda).to(dtype)
               for x in flash_case((1, 4, 2, 300, 200, 64)))
    with pytest.raises(ValueError, match="Sq <= Skv"):
        FK.flash_attention_cuda(q, k, v, causal=causal, window=window)
    out = torch.empty_like(q)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with pytest.raises(RuntimeError, match="flash_attention_launch failed"):
        load_library("prefill").call(
            "flash_attention_launch", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), 1, 4, 2, 300, 200, 64, *strides,
            int(causal), int(window is not None), int(window or 0),
            ctypes.c_float(0.125), int(dtype == torch.bfloat16),
            ctypes.byref(ctypes.c_int()), stream_of(q))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_prefill_library_runs_wgmma_and_tma(cuda):
    """The built prefill library's machine code holds Hopper's warpgroup
    products (HGMMA) and TMA tensor loads (UTMALDG): K7's bf16 path runs on
    them. Skips only where the toolkit has no cuobjdump."""
    import pathlib
    import shutil
    import subprocess
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels.build import load_library
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump")
    if not pathlib.Path(tool).exists():
        pytest.skip("cuobjdump not found in the CUDA toolkit")
    sass = subprocess.run([tool, "-sass", str(load_library("prefill").path)],
                          capture_output=True, text=True, check=True).stdout
    assert "HGMMA" in sass and "UTMALDG" in sass


# Zamba2-7B's Mamba2 widths (112 heads of 64, state 64, one group) at
# S = 8,192 in chunks of 64: 128 chunks of state carry
SSD_ZAMBA2_8K = (1, 8192, 112, 64, 64, 64, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSD_SHAPES + [SSD_ZAMBA2_8K])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["test", "init", "strong"])
def test_ssd_scan_matches_plain_on_card(shape, bc_dtype, decay, cuda):
    """K8 against its plain version, NaN-free under decays that underflow.
    Both compute in float32 with a_cum in float64, so the bound (atol 1e-5,
    rtol 1e-4) is tighter than the reference's kernel-test bound (atol
    1e-4, rtol 5e-2), which the CPU tests against the reference keep; a
    kernel computing in bf16 or TF32 fails it."""
    from repro_torch.kernels.ssd_scan import ops as SSD
    from repro_torch.kernels.ssd_scan import ref as SSD_REF
    x, a, bb, cc = (torch.as_tensor(t, device=cuda)
                    for t in ssd_case(shape, decay=decay))
    bb, cc = bb.to(bc_dtype), cc.to(bc_dtype)
    chunk = shape[5]
    y, h = SSD.ssd_scan(x, a, bb, cc, chunk=chunk)
    y_ref, h_ref = SSD_REF.ssd_scan_ref(x, a, bb, cc, chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(h, h_ref, atol=1e-5, rtol=1e-4)
    torch.cuda.synchronize()


# ------------------------------------------- the Mamba2 decode state ----
# (b, h, p, n, g): Zamba2-7B's Mamba2 widths at the decode cell's B=256
# (112 heads of 64, state 64, 2 groups), mamba2-130m's (32 heads of 48,
# state 128, 1 group), both at an odd B, the smoke configs' 16 x 16, and
# an N of 20 (5 of a row's 8 lanes hold columns) with P=7 and 3 groups
SSD_DECODE_SHAPES = [(256, 112, 64, 64, 2), (256, 32, 48, 128, 1),
                     (3, 112, 64, 64, 2), (3, 32, 48, 128, 1),
                     (3, 8, 16, 16, 1), (2, 6, 7, 20, 3)]


def ssd_decode_case(shape, seed=0):
    """Seeded decode-state inputs in float32: h [B,H,P,N], x [B,H,P], b/c
    [B,G,N], dt [B,H] (softplus of N(0, 1.2), as the init's dt), da =
    exp(-dt) and D [H]."""
    b, h, p, n, g = shape
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.standard_normal((b, h)) * 1.2, 0.0)
    return (rng.standard_normal((b, h, p, n)).astype(np.float32),
            (rng.standard_normal((b, h, p)) * 0.5).astype(np.float32),
            (rng.standard_normal((b, g, n)) * 0.5).astype(np.float32),
            (rng.standard_normal((b, g, n)) * 0.5).astype(np.float32),
            dt.astype(np.float32), np.exp(-dt).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSD_DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_decode_matches_plain_on_card(shape, dtype, cuda):
    """The decode-state kernel on layer slice 2 of a stacked [4, B, H, P,
    N] cache against its plain version: the state updated in place and
    equal bit for bit (the same float64 multiply-add, one rounding), the
    neighbouring layers untouched, y within 1e-5 (only the order of its sum
    over N differs), one launch counted."""
    from repro_torch.kernels.ssd_decode import ops as SDEC
    from repro_torch.kernels.ssd_decode import ref as SDEC_REF
    h, x, b, c, dt, da, D = (torch.as_tensor(a, device=cuda)
                             for a in ssd_decode_case(shape))
    x, b, c = (t.to(dtype) for t in (x, b, c))
    L, idx = 4, 2
    stack = torch.randn((L, *h.shape), generator=torch.Generator(
        cuda).manual_seed(1), device=cuda)
    stack[idx] = h
    before = stack.clone()
    want_h, want_y = SDEC_REF.ssd_decode_ref(h, x, b, c, dt, da, D)
    n0 = SDEC.ssd_decode.launches
    got_h, got_y = SDEC.ssd_decode(stack[idx], x, b, c, dt, da, D)
    torch.cuda.synchronize()
    assert SDEC.ssd_decode.launches == n0 + 1
    assert got_h.data_ptr() == stack[idx].data_ptr()
    assert torch.equal(stack[idx].view(torch.int32),
                       want_h.view(torch.int32))
    for layer in range(L):
        if layer != idx:
            assert torch.equal(stack[layer].view(torch.int32),
                               before[layer].view(torch.int32)), layer
    torch.testing.assert_close(got_y, want_y, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_hybrid_serve_step_decode_state_kernel_on_card(cuda):
    """The hybrid serve step at the smoke widths in float32 with 2 groups,
    impl "cuda" against "ref" over 16 greedy steps: the same tokens, logits
    within 1e-4, the decode-state kernel launched once a Mamba2 layer a
    step under "cuda" and never under "ref"."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TieringConfig
    from repro_torch.kernels.ssd_decode import ops as SDEC
    from repro_torch.models.transformer import make_model
    from repro_torch.serve import decode as SD
    cfg = dataclasses.replace(get_smoke_config("zamba2_7b"), dtype="float32")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           ngroups=2))
    tcfg = TieringConfig(n_tenants=2, page_tokens=4, thrash_table_slots=64,
                         lower_protection=(2, 2), upper_bound=(3, 3))
    B, steps = 8, 16
    model = make_model(cfg, seed=0, device=cuda)
    tokens = {}
    for impl in ("cuda", "ref"):
        step = SD.build_serve_step(cfg, tcfg, B, steps, impl=impl,
                                   device=cuda)
        state = SD.init_serve_state(cfg, tcfg, B, steps, device=cuda)
        tok = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
        out, logits = [], []
        n0 = SDEC.ssd_decode.launches
        for _ in range(steps):
            lg, state = step(model, state, tok)
            tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True).to(
                torch.int32)
            out.append(tok)
            logits.append(lg)
        launched = SDEC.ssd_decode.launches - n0
        assert launched == (cfg.num_layers * steps if impl == "cuda"
                            else 0), impl
        tokens[impl] = (torch.cat(out, dim=1), torch.cat(logits, dim=1))
    assert torch.equal(tokens["cuda"][0], tokens["ref"][0])
    torch.testing.assert_close(tokens["cuda"][1], tokens["ref"][1],
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------- dynamic ownership (churn) ----
# K1 over the dynamic path's run-time rowspace: T rows of S = L lanes, past
# the 24,576 lanes the kernel stages in shared memory (its long route);
# free-pool sentinels (owner == T), integer scores (ties) and quotas around
# 0 and k; a churned host's width (T=64, L=261,824) and a single row
DYNAMIC_ROWSPACES = ((4, 30000, 64), (9, 40000, 256), (3, 70001, 300),
                     (64, 261824, 256), (1, 262144, 256))


@pytest.mark.gpu
@pytest.mark.parametrize("T,L,k_max", DYNAMIC_ROWSPACES)
def test_kernel_dynamic_strategy_matches_ref_on_card(T, L, k_max, cuda):
    from repro_torch.core import select as SEL
    rng = np.random.default_rng(L)
    owner = torch.as_tensor(rng.integers(0, T + 1, L).astype(np.int32),
                            device=cuda)
    score = rng.standard_normal(L).astype(np.float32)
    score[::3] = rng.integers(-5, 5, score[::3].shape)
    score = torch.as_tensor(score, device=cuda)
    active = torch.as_tensor(rng.random(L) < 0.7, device=cuda) & (owner < T)
    quotas = torch.as_tensor(rng.integers(-1, k_max + 40, T).astype(np.int32),
                             device=cuda)
    quotas[0] = 0 if T > 1 else k_max     # a single row takes its k_max
    a = SEL.kernel_dynamic_strategy(T, k_max, impl="cuda", device=cuda)
    b = SEL.kernel_dynamic_strategy(T, k_max, impl="ref", device=cuda)
    before = TSEL.seg_topk.launches
    got = a.select(score, owner, active, quotas).mask
    assert TSEL.seg_topk.launches == before + 1
    want = b.select(score, owner, active, quotas).mask
    assert torch.equal(got, want)
    assert int(got.sum()) > 0
    torch.cuda.synchronize()


def _chip_smoke():
    """``chip_smoke.py``'s copy of the golden fixtures' collect and diff
    (this file imports nothing of the reference)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["churn_small", "churn16_sketch"])
def test_churn_golden_with_cuda_impl(name, cuda):
    """The churn goldens through ``simulate_churn(impl="cuda")``: ints
    exact, floats within atol 1e-4. K1 launches on churn_small's dynamic
    path; under the sketch every selection runs over its buffers."""
    import json
    smoke = _chip_smoke()
    before = TSEL.seg_topk.launches
    r = smoke.churn_golden_run(name, impl="cuda", device=cuda)
    assert (TSEL.seg_topk.launches > before) == (name == "churn_small")
    want = json.loads((smoke.GOLDEN.parent / f"{name}.json").read_text())
    got = smoke.collect(r)
    assert sorted(want) == sorted(got)
    for key in sorted(want):
        smoke.diff(got[key], want[key], key)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["equilibria", "tpp", "memtis", "static"])
def test_non_contiguous_static_owner_cuda_equals_ref_on_card(mode, cuda):
    from repro_torch.configs.base import TieringConfig
    from repro_torch.core import workloads as W
    from repro_torch.core.engine import run_engine
    tenants = [W.microbenchmark(40), W.web_like(48, arrival=6),
               W.ci_like(36, phase_len=12), W.stream_like(30)]
    owner, acc, alive = W.build_trace(tenants, 40)
    perm = np.random.default_rng(0).permutation(owner.shape[0])
    cfg = TieringConfig(n_tenants=4, n_fast_pages=64, n_slow_pages=154,
                        lower_protection=(16, 16, 0, 0),
                        upper_bound=(0, 28, 0, 20))
    runs = [run_engine(cfg, owner[perm], acc[:, perm], alive[:, perm],
                       mode=mode, k_max=16, impl=impl, device=cuda)
            for impl in ("cuda", "ref")]
    (sa, oa), (sb, ob) = runs
    for f in oa._fields:
        x, y = getattr(oa, f), getattr(ob, f)
        if x.is_floating_point():
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
        else:
            assert torch.equal(x, y), f
    assert torch.equal(sa.tier, sb.tier) and torch.equal(sa.ring.data,
                                                         sb.ring.data)


# ------------------------------------------------ the fleet (slice D) ----
def _two_host_fleet():
    """A static host and a churned one (a thrasher under an upper bound
    from tick 10) over a squeezed 64-page fast tier, 30 ticks."""
    from repro_torch.configs.base import TieringConfig
    from repro_torch.core import workloads as W
    from repro_torch.obs import fleet as F
    static = W.as_churn_slots([W.web_like(40), W.cache_like(40),
                               W.spark_like(32), W.web_like(32)], 30)
    churned = [W.ChurnSlot(W.web_like(40), [(0, 30)]),
               W.ChurnSlot(W.cache_like(40), [(0, 30)]),
               W.ChurnSlot(W.spark_like(32), [(4, 22)]),
               W.ChurnSlot(W.thrasher(32, fast_share=10), [(10, 30)])]
    cfg = TieringConfig(n_tenants=4, n_fast_pages=64, n_slow_pages=128,
                        lower_protection=(4, 4, 4, 4),
                        upper_bound=(24, 0, 0, 10), p_base=16)
    want, rates = F.stack_schedules([W.build_churn_schedule(s, 30)
                                     for s in (static, churned)])
    return cfg, want, rates


def _same_leaves(a, b):
    smoke = _chip_smoke()
    la, lb = smoke.state_leaves(a), smoke.state_leaves(b)
    assert sorted(la) == sorted(lb)
    for k, x in la.items():
        if torch.is_tensor(x):
            assert x.dtype == lb[k].dtype and torch.equal(x, lb[k]), k
        else:
            assert x == lb[k], k


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [30, 7])
def test_fleet_rollout_cuda_equals_ref_with_seams_on_card(chunk, cuda):
    """``fleet_rollout`` with the streaming detectors and the attribution
    ledger: impl="cuda" == impl="ref" in every state leaf (det and attrib
    included) and in the ledger; chunk=7 == chunk=30 the same way. K1
    launches."""
    from repro_torch.obs import fleet as F
    cfg, want, rates = _two_host_fleet()
    before = TSEL.seg_topk.launches
    rolls = {impl: F.fleet_rollout(cfg, want, rates, 30, k_max=16,
                                   chunk=chunk, impl=impl, device=cuda)
             for impl in ("cuda", "ref")}
    assert TSEL.seg_topk.launches > before
    a, b = rolls["cuda"], rolls["ref"]
    assert a.final_state.det is not None and a.final_state.attrib is not None
    _same_leaves(a.final_state, b.final_state)
    for f in a.ledger.total["counters"]._fields:
        assert np.array_equal(getattr(a.ledger.total["counters"], f),
                              getattr(b.ledger.total["counters"], f)), f
    assert np.array_equal(a.migrations_per_tick, b.migrations_per_tick)
    assert a.attribution_conserved() and b.attribution_conserved()
    assert int(a.attribution_totals().sum()) > 0
    if chunk != 30:
        whole = F.fleet_rollout(cfg, want, rates, 30, k_max=16, chunk=30,
                                impl="cuda", device=cuda)
        _same_leaves(a.final_state, whole.final_state)
        np.testing.assert_array_equal(a.attribution_totals(),
                                      whole.attribution_totals())
        np.testing.assert_allclose(a.latency_mean, whole.latency_mean,
                                   rtol=1e-6)


# ------------------------------------- the decoder families (slice E1/F2a) ----
FAMILY_ARCHS = ("granite_moe_3b_a800m", "mixtral_8x22b", "codeqwen15_7b",
                "h2o_danube_3_4b", "qwen3_32b", "mamba2_130m")


def _family_leaves(state):
    """Every tensor of a serve state by dotted name (the KV cache's
    metadata and pools, the Mamba2 state); the migration ring's hotness
    column, float bits in an int32 array, as floats."""
    out = {}
    for key, tree in state.items():
        for f in tree._fields:
            v = getattr(tree, f)
            if hasattr(v, "_fields"):
                out.update({f"{key}.{f}.{g}": getattr(v, g)
                            for g in v._fields})
            elif torch.is_tensor(v):
                out[f"{key}.{f}"] = v
    if "kv.ring.data" in out:
        ring = out.pop("kv.ring.data")
        out["kv.ring.data"] = ring[:, :4]
        out["kv.ring.hot"] = ring[:, 4].contiguous().view(torch.float32)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["equilibria", "tpp", "static"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_serve_step_cuda_equals_ref_on_card(arch, mode, cuda):
    """The new families' serve steps at their smoke widths in float32,
    impl "cuda" (K5, K6) against "ref" over 48 steps (past the windowed
    configs' window of 32), two tenants bounded at 3 pages: integer state
    bitwise, floats and logits within 1e-4 (float32 sums in another
    order)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TieringConfig
    from repro_torch.models.transformer import make_model
    from repro_torch.serve import decode as SD
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tcfg = TieringConfig(n_tenants=2, page_tokens=4, thrash_table_slots=64,
                         lower_protection=(2, 2), upper_bound=(3, 3))
    B, steps = 8, 48
    model = make_model(cfg, seed=0, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, steps)).astype(np.int32), device=cuda)
    step_c = SD.build_serve_step(cfg, tcfg, B, steps, mode=mode,
                                 impl="cuda", device=cuda)
    step_r = SD.build_serve_step(cfg, tcfg, B, steps, mode=mode,
                                 impl="ref", device=cuda)
    sc = SD.init_serve_state(cfg, tcfg, B, steps, device=cuda)
    sr = SD.init_serve_state(cfg, tcfg, B, steps, device=cuda)
    with torch.no_grad():
        for i in range(steps):
            lc, sc = step_c(model, sc, toks[:, i:i + 1])
            lr, sr = step_r(model, sr, toks[:, i:i + 1])
            torch.testing.assert_close(lc, lr, atol=1e-4, rtol=1e-4)
            a, b = _family_leaves(sc), _family_leaves(sr)
            assert sorted(a) == sorted(b)
            for name, x in a.items():
                if x.is_floating_point():
                    torch.testing.assert_close(x, b[name], atol=1e-4,
                                               rtol=1e-4, msg=name)
                else:
                    assert torch.equal(x, b[name]), f"step {i}: {name}"
    if "kv" in sc:
        assert sc["kv"].t == steps == sr["kv"].t


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_prefill_cuda_equals_ref_on_card(arch, cuda):
    """``make_prefill_step`` of the new families at their smoke widths in
    float32 at S=64 (past the smoke window), impl "cuda" (K7, or K8 for
    mamba2) against "ref", within 1e-4 of max |logit|."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import make_model
    from repro_torch.train.step import make_prefill_step
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = make_model(cfg, seed=0, device=cuda)
    toks = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32), device=cuda)}
    got = make_prefill_step(cfg, impl="cuda", device=cuda)(model, toks)
    want = make_prefill_step(cfg, impl="ref", device=cuda)(model, toks)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 1e-4, rel


# ------------------------------------- K7 and K8 under autograd (train) ----
# (b, h, kh, sq, skv, d, dtype, causal, window): phase 35's shapes at B=1
# (Llama 3.2 1B's GQA, Zamba2's D=112, h2o-danube's D=120 in float32, a
# 4,096 window past its length, whisper's encoder 1,500 x 1,500 and a cross
# Sq > Skv), then an odd S and head dims 16 and 128
GRAD_SHAPES = [
    (1, 32, 8, 4096, 4096, 64, torch.bfloat16, True, None),
    (1, 32, 32, 2048, 2048, 112, torch.bfloat16, True, None),
    (1, 32, 8, 2048, 2048, 120, torch.float32, True, None),
    (1, 8, 2, 5000, 5000, 64, torch.bfloat16, True, 4096),
    (1, 6, 6, 1500, 1500, 64, torch.bfloat16, False, None),
    (1, 6, 6, 4096, 1500, 64, torch.bfloat16, False, None),
    (2, 4, 2, 201, 201, 16, torch.float32, True, None),
    (1, 4, 1, 333, 333, 128, torch.bfloat16, True, 100),
]
# the backward is the plain version's gradient at the same inputs and the
# same incoming gradient: it may differ from autograd of the plain version
# only where the library picks another product algorithm
FN_GRAD_RTOL = 1e-5


def _rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GRAD_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:6])) + (
                             f"-{str(s[6])[6:]}-c{int(s[7])}-w{s[8]}"))
def test_flash_attention_gradients_match_plain_autograd_on_card(shape,
                                                                 cuda):
    """q, k and v's gradients through ``FlashAttention`` (K7 forward) equal
    ``torch.autograd`` of the plain version on the same inputs and the
    same incoming gradient; the forward is K7's, held within the kernel
    tolerance; only the Function's forward launches."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    b, h, kh, sq, skv, d, dt, causal, window = shape
    g = torch.Generator(device=cuda).manual_seed(35)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt)
               for s in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d)))
    do = torch.randn((b, h, sq, d), generator=g, device=cuda).to(dt)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = FA.flash_attention.launches
    out = FA.flash_attention(*ins, causal=causal, window=window)
    assert FA.flash_attention.launches == n0 + 1
    assert out.grad_fn is not None
    out.backward(do)
    assert FA.flash_attention.launches == n0 + 1
    want = FA_REF.flash_attention_ref(*ref_ins, causal=causal, window=window)
    want.backward(do)
    tol = 2e-5 if dt == torch.float32 else 2e-2
    assert _rel_err(out, want) < tol
    for name, a, r in zip("qkv", ins, ref_ins):
        assert a.grad.dtype == dt and torch.isfinite(a.grad).all(), name
        assert _rel_err(a.grad, r.grad) <= FN_GRAD_RTOL, name


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSD_SHAPES + [(1, 4096, 32, 48, 128, 256,
                                                 1)])
@pytest.mark.parametrize("use_h", [True, False])
def test_ssd_scan_gradients_match_plain_autograd_on_card(shape, use_h, cuda):
    """x, a, b and c's gradients through ``SSDScan`` (K8 forward) equal
    ``torch.autograd`` of the plain version, with h_final's gradient used
    and unused (then materialised as zeros); the last shape is
    mamba2-130m's (H=32, P=48, N=128, chunk 256) at S=4,096."""
    from repro_torch.kernels.ssd_scan import ops as SSD
    from repro_torch.kernels.ssd_scan import ref as SSD_REF
    chunk = shape[5]
    arrs = [torch.as_tensor(a, device=cuda)
            for a in ssd_case(shape, decay="init")]
    ins = [t.clone().requires_grad_(True) for t in arrs]
    ref_ins = [t.clone().requires_grad_(True) for t in arrs]
    g = torch.Generator(device=cuda).manual_seed(8)
    y, h = SSD.ssd_scan(*ins, chunk=chunk)
    gy = torch.randn(y.shape, generator=g, device=cuda)
    gh = torch.randn(h.shape, generator=g, device=cuda)
    yr, hr = SSD_REF.ssd_scan_ref(*ref_ins, chunk)
    if use_h:
        torch.autograd.backward((y, h), (gy, gh))
        torch.autograd.backward((yr, hr), (gy, gh))
    else:
        y.backward(gy)
        yr.backward(gy)
    assert _rel_err(y, yr) < 1e-4
    for name, a, r in zip("xabc", ins, ref_ins):
        assert torch.isfinite(a.grad).all(), name
        assert _rel_err(a.grad, r.grad) <= FN_GRAD_RTOL, name


TRAIN_ARCHS = ("llama32_1b", "mamba2_130m", "zamba2_7b",
               "granite_moe_3b_a800m", "whisper_tiny")
# cuda vs ref after one step from the same weights: K7's and K8's float32
# forwards differ from the plain versions in the last bits, which the
# backward carries into every gradient
TRAIN_GRAD_RTOL = 1e-3


def _train_once(arch, impl, remat, cuda):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.transformer import make_model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = make_model(cfg, seed=0, device=cuda)
    step = make_train_step(cfg, TrainConfig(remat_policy=remat), impl=impl,
                           device=cuda)
    batch = synthetic_batch(cfg, 2, 64, seed=3, device=cuda)
    _, metrics = step(model, init_opt_state(model), batch)
    return model, metrics


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_cuda_matches_ref_on_card(arch, cuda):
    """One ``impl="cuda"`` training step of a smoke model in float32: every
    parameter's ``.grad`` present and finite, and within
    ``TRAIN_GRAD_RTOL`` of each leaf's scale of the ``impl="ref"`` step's;
    the loss within 1e-5."""
    mc, m_c = _train_once(arch, "cuda", "block", cuda)
    mr, m_r = _train_once(arch, "ref", "block", cuda)
    assert abs(float(m_c["loss"]) - float(m_r["loss"])) <= 1e-5 * abs(
        float(m_r["loss"]))
    ref = dict(mr.named_parameters())
    for name, p in mc.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert _rel_err(p.grad, ref[name].grad) <= TRAIN_GRAD_RTOL, name


@pytest.mark.gpu
@pytest.mark.parametrize("remat,per_layer", [("block", 2), ("none", 1)])
def test_train_step_launches_per_layer_on_card(remat, per_layer, cuda):
    """K7 (dense) and K8 (ssm) launch once per layer in the forward, and
    once more in each layer's recomputation with block remat."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssd_scan import ops as SSD
    for arch, op in (("llama32_1b", FA.flash_attention),
                     ("mamba2_130m", SSD.ssd_scan)):
        n0 = op.launches
        model, _ = _train_once(arch, "cuda", remat, cuda)
        assert op.launches - n0 == per_layer * model.cfg.num_layers, arch


@pytest.mark.gpu
def test_spans_time_the_device_and_skip_capture(cuda):
    """The span recorder on the card: its events give each span's device
    time, a child's within its parent's; under ``torch.cuda.graph`` capture
    it records nothing, and the captured graph replays."""
    from repro_torch.obs import spans
    a = torch.randn(2048, 2048, device=cuda)
    spans.reset()
    spans.enable()
    try:
        for _ in range(3):
            with spans.span("serve.step"):
                with spans.span("serve.mamba"):
                    b = a @ a
                b = b + 1
        torch.cuda.synchronize()
        rows = spans.summary()
        step, child = rows["serve.step"], rows["serve.mamba"]
        assert (step["steps"], step["calls"], child["calls"]) == (3, 3, 3)
        assert 0 < child["device_ms"] <= step["device_ms"]
        assert step["self_device_ms"] >= -1e-3
        spans.reset()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            c = a @ a                        # warm the product off the graph
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with spans.span("serve.step"):
                c = a @ a
        graph.replay()
        torch.cuda.synchronize()
        assert spans.summary() == {}
        assert torch.allclose(c, b - 1, rtol=1e-3, atol=1e-2)
    finally:
        spans.disable()
        spans.reset()
