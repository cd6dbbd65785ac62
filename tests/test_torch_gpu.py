"""The hand-written CUDA kernels held against their plain torch versions on
the card (marker ``gpu``; skips without a CUDA device).

This file imports neither jax nor the reference package, so it also runs on
a machine that has only torch. On the card:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports jax). The seeded
edge cases here also feed ``tests/test_torch_kernels.py``, which holds the
plain versions against the reference on the CPU: ties from integer scores,
+-inf and NaN scores, zero and negative quotas, k > S, ring overflow and a
ring head near 2**31.
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
