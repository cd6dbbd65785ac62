"""The port's kernels (K1-K6) held against the reference.

On the CPU each port wrapper (``repro_torch.kernels.*.ops``) runs its
kernel's plain torch version; these tests give it and the reference's
wrappers (``repro.kernels.*.ops`` with impl="ref" and "pallas_interpret")
the same seeded numpy inputs, on the edge cases the kernels must get right:
ties from integer scores, +-inf and NaN scores, zero and negative quotas,
k > S, ring overflow (more taken lanes than the ring holds) and a ring head
near 2**31 (the seeded cases of ``tests/test_torch_gpu.py``, which holds
the CUDA kernels against the same plain versions on the card). Every
output of K1-K4 and K6 is compared bitwise; K5 (tiered attention) sums
floats in another order than XLA, so within atol 2e-5 (float32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.migrate.ops import commit_moves as j_commit_moves
from repro.kernels.migrate.ops import migrate_pages as j_migrate_pages
from repro.kernels.select.ops import seg_reduce as j_seg_reduce
from repro.kernels.select.ops import seg_sums as j_seg_sums
from repro.kernels.select.ops import seg_topk as j_seg_topk
from repro.kernels.tiered_attention.ops import tiered_attention as j_tiered
from repro.kernels.tiered_attention.ref import \
    pool_attention_partial_ref as j_partial_ref
from repro.memtier.kvcache import tiered_paged_attention as j_serving_attn
from repro_torch.kernels.migrate import ops as TMIG
from repro_torch.kernels.select import ops as TSEL
from repro_torch.kernels.tiered_attention import ops as TTA
from test_torch_gpu import (ATTN_SHAPES, MIGRATE_SHAPES, attention_case,
                            migrate_case, moves_case, topk_case)

JAX_IMPLS = ("ref", "pallas_interpret")


def _eq(port, ref, name):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=name)


# ------------------------------------------------------------- seg_topk ----
@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("seed", range(8))
def test_seg_topk_matches_reference(seed, impl):
    score, valid, quotas, k = topk_case(seed)
    want = j_seg_topk(jnp.asarray(score), jnp.asarray(valid),
                      jnp.asarray(quotas), k, impl=impl)
    got = TSEL.seg_topk(torch.as_tensor(score), torch.as_tensor(valid),
                        torch.as_tensor(quotas), k)
    for name, g, w in zip(("cols", "take", "counts"), got, want):
        _eq(g, w, name)


def test_seg_topk_ties_go_to_lowest_column():
    score = torch.zeros((1, 32))
    cols, take, counts = TSEL.seg_topk(score, torch.ones((1, 32), dtype=bool),
                                       torch.tensor([4], dtype=torch.int32), 8)
    assert cols[0, :4].tolist() == [0, 1, 2, 3]
    assert cols[0, 4:].tolist() == [32] * 4
    assert take[0].tolist() == [True] * 4 + [False] * 4
    assert int(counts[0]) == 4


# ------------------------------------------------- seg_reduce / seg_sums ----
@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("seed", range(6))
def test_seg_reduce_and_sums_match_reference(seed, impl):
    rng = np.random.default_rng(100 + seed)
    T = int(rng.choice([1, 5, 8]))
    S = int(rng.choice([1, 64, 200]))
    if seed % 3 == 2:       # full-range values: the row sums wrap
        x = rng.integers(-2**31, 2**31, (T, S), dtype=np.int64
                         ).astype(np.int32)
    else:
        x = rng.integers(-8, 8, (T, S)).astype(np.int32)
    valid = rng.random((T, S)) < rng.choice([0.0, 0.5, 1.0])
    js, jp = j_seg_reduce(jnp.asarray(x), jnp.asarray(valid), impl=impl)
    ts, tp = TSEL.seg_reduce(torch.as_tensor(x), torch.as_tensor(valid))
    _eq(ts, js, "sums")
    _eq(tp, jp, "prefix")
    _eq(TSEL.seg_sums(torch.as_tensor(x), torch.as_tensor(valid)),
        j_seg_sums(jnp.asarray(x), jnp.asarray(valid), impl=impl), "sums")


# --------------------------------------------------------- commit_moves ----
@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("seed", range(8))
def test_commit_moves_matches_reference(seed, impl):
    (tier, data, head, pages, take, tenants, hot, t, direction,
     to_tier) = moves_case(seed)
    want = j_commit_moves(jnp.asarray(tier), jnp.asarray(data),
                          jnp.asarray(head), jnp.asarray(pages),
                          jnp.asarray(take), jnp.asarray(tenants),
                          jnp.asarray(hot), jnp.asarray(np.int32(t)),
                          direction=direction, to_tier=to_tier, impl=impl)
    got = TMIG.commit_moves(torch.as_tensor(tier), torch.as_tensor(data),
                            torch.as_tensor(head), torch.as_tensor(pages),
                            torch.as_tensor(take), torch.as_tensor(tenants),
                            torch.as_tensor(hot), t, direction=direction,
                            to_tier=to_tier)
    for name, g, w in zip(("tier", "ring_data", "head"), got, want):
        _eq(g, w, name)


def test_commit_moves_ring_overflow_keeps_newest():
    """More taken lanes than ring slots: only the newest C land, in order."""
    C, N = 4, 10
    got = TMIG.commit_moves(
        torch.zeros(16, dtype=torch.int32),
        torch.full((C, 5), -1, dtype=torch.int32),
        torch.tensor(2**31 - 2, dtype=torch.int32),
        torch.arange(N, dtype=torch.int32), torch.ones(N, dtype=bool),
        torch.zeros(N, dtype=torch.int32), torch.zeros(N), 3,
        direction=0, to_tier=1)
    tier, ring, head = got
    assert tier[:N].tolist() == [1] * N and tier[N:].tolist() == [0] * 6
    assert int(head) == (2**31 - 2 + N) - 2**32        # int32 wrap
    # lane i sits at floor_mod(head0 + i, C); lanes 6..9 survive
    head0 = 2**31 - 2
    for lane in range(6, N):
        slot = ((head0 + lane + 2**31) % 2**32 - 2**31) % C
        assert ring[slot, 2].item() == lane


# ----------------------------------------------------- tiered attention ----
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("window", [None, 40])
def test_pool_attention_partial_matches_reference(shape, window):
    """K5's plain version against the reference's plain version, per pool:
    (acc, m, l, mass) with mass relative to each head's final m."""
    q, fk, fv, sk, sv, fp, sp, seq_len = attention_case(shape)
    for pk, pv, page in ((fk, fv, fp), (sk, sv, sp)):
        want = j_partial_ref(jnp.asarray(q[:, 0]), jnp.asarray(pk),
                             jnp.asarray(pv), jnp.asarray(page),
                             jnp.asarray(seq_len), window=window)
        got = TTA.pool_attention_partial(
            torch.as_tensor(q[:, 0]), torch.as_tensor(pk),
            torch.as_tensor(pv), torch.as_tensor(page),
            torch.as_tensor(seq_len), window=window)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("window", [None, 40])
def test_tiered_attention_matches_reference(shape, window, impl):
    """The merged two-tier attention against the reference's wrapper, on
    its plain version and on the Pallas kernel in interpret mode."""
    args = attention_case(shape)
    want = j_tiered(*(jnp.asarray(a) for a in args), window=window,
                    impl=impl, page_block=4)
    got = TTA.tiered_attention(*(torch.as_tensor(a) for a in args),
                               window=window, impl="ref")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-5)


def test_tiered_attention_matches_serving_path():
    """The kernel route equals the reference's serving-path function, which
    takes token-validity masks built from the same page metadata."""
    q, fk, fv, sk, sv, fp, sp, seq_len = attention_case(ATTN_SHAPES[0])
    pt = fk.shape[2]

    def valid(page):
        tok = page[:, :, None] * pt + np.arange(pt)
        return (page >= 0)[:, :, None] & (tok <= seq_len[:, None, None])

    want = j_serving_attn(*(jnp.asarray(a) for a in (q, fk, fv, sk, sv)),
                          jnp.asarray(valid(fp)), jnp.asarray(valid(sp)))
    got = TTA.tiered_attention(*(torch.as_tensor(a) for a in
                                 (q, fk, fv, sk, sv, fp, sp, seq_len)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


# -------------------------------------------------------- migrate pages ----
@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("shape", MIGRATE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_migrate_pages_matches_reference(shape, dtype, impl):
    """K6's plain version, bitwise, in place; all-unselected and source
    slot == destination slot included."""
    src, dst, si, di, sel = migrate_case(shape)
    same = np.minimum(si, min(src.shape[2], dst.shape[2]) - 1)
    tdt = getattr(torch, dtype)
    for s_i, d_i, se in ((si, di, sel), (same, same, sel),
                         (si, di, np.zeros_like(sel))):
        want = j_migrate_pages(jnp.asarray(src, dtype),
                               jnp.asarray(dst, dtype), jnp.asarray(s_i),
                               jnp.asarray(d_i), jnp.asarray(se), impl=impl)
        dst_t = torch.as_tensor(dst).to(tdt)
        got = TMIG.migrate_pages(torch.as_tensor(src).to(tdt), dst_t,
                                 torch.as_tensor(s_i), torch.as_tensor(d_i),
                                 torch.as_tensor(se))
        assert got is dst_t                  # updated in place
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want, np.float32))
