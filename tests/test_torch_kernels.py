"""The port's selection-core kernels (K1-K4) held against the reference.

On the CPU each port wrapper (``repro_torch.kernels.*.ops``) runs its
kernel's plain torch version; these tests give it and the reference's
wrappers (``repro.kernels.*.ops`` with impl="ref" and "pallas_interpret")
the same seeded numpy inputs, on the edge cases the kernels must get right:
ties from integer scores, +-inf and NaN scores, zero and negative quotas,
k > S, ring overflow (more taken lanes than the ring holds) and a ring head
near 2**31 (the seeded cases of ``tests/test_torch_gpu.py``, which holds
the CUDA kernels against the same plain versions on the card). Every
output is compared bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.migrate.ops import commit_moves as j_commit_moves
from repro.kernels.select.ops import seg_reduce as j_seg_reduce
from repro.kernels.select.ops import seg_sums as j_seg_sums
from repro.kernels.select.ops import seg_topk as j_seg_topk
from repro_torch.kernels.migrate import ops as TMIG
from repro_torch.kernels.select import ops as TSEL
from test_torch_gpu import moves_case, topk_case

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
