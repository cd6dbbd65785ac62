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
from repro.kernels.tiered_attention.kernel import \
    pool_attention_partial_tpu as j_partial_tpu
from repro.kernels.tiered_attention.ops import tiered_attention as j_tiered
from repro.kernels.tiered_attention.ref import \
    pool_attention_partial_ref as j_partial_ref
from repro.memtier.kvcache import tiered_paged_attention as j_serving_attn
from repro_torch.kernels.migrate import ops as TMIG
from repro_torch.kernels.select import ops as TSEL
from repro_torch.kernels.tiered_attention import kernel as TTA_K
from repro_torch.kernels.tiered_attention import ops as TTA
from repro_torch.kernels.tiered_attention import ref as TTA_REF
from repro_torch.kernels.select import ref as TSEL_REF
from test_torch_gpu import (ATTN_SHAPES, MIGRATE_CARD_SHAPES,
                            MIGRATE_ODD_SHAPES, MIGRATE_SHAPES,
                            MOVES_CARD_CASES, SUMS_CARD_SHAPES,
                            TOPK_EDGE_CASES, attention_case, migrate_case,
                            migrate_index_cases, moves_card_case, moves_case,
                            sums_card_case, topk_case, topk_edge_case)

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


# The CUDA kernel's algorithm (csrc/selection.cu seg_topk_kernel), modelled in
# numpy so that its logic is pinned where no kernel runs: 64-bit keys, a
# radix select of the threshold over 8-bit digits from the top, the stop
# once every key under the prefix is a winner, winners taken in chunks of
# the in-shared-memory sort's capacity by rank, each chunk sorted by key.
def _topk_keys(score, valid):
    """The kernel's keys: the score's bits mapped to an order-preserving
    unsigned (-0.0 folded into +0.0) over the complemented column; 0 where
    the column is not eligible."""
    S = score.shape[-1]
    bits = np.where(score == 0, np.float32(0), score).astype(
        np.float32).view(np.uint32).astype(np.uint64)
    order = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF,
                     bits | 0x80000000)
    keys = (order << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - np.arange(S, dtype=np.uint64))
    return np.where(valid & np.isfinite(score), keys, np.uint64(0))


def _radix_threshold(keys, need):
    """The smallest key of the ``need`` largest: one 256-bin histogram pass
    per digit over the keys still under the chosen prefix."""
    prefix, sh = 0, 56
    while True:
        live = keys != 0
        if sh < 56:
            live &= (keys >> np.uint64(sh + 8)) == np.uint64(prefix)
        hist = np.bincount(((keys[live] >> np.uint64(sh)) & np.uint64(255))
                           .astype(np.int64), minlength=256)
        above = 0
        for digit in range(255, -1, -1):
            if above + hist[digit] >= need:
                break
            above += hist[digit]
        prefix = (prefix << 8) | digit
        need -= above
        if hist[digit] == need or sh == 0:
            return np.uint64(prefix << sh)
        sh -= 8


def radix_topk_model(score, valid, quotas, k, cap=2048):
    T, S = score.shape
    keys = _topk_keys(score, valid)
    cols = np.full((T, k), S, np.int32)
    take = np.zeros((T, k), bool)
    counts = np.zeros(T, np.int32)
    for t in range(T):
        row = keys[t]
        r = min(max(int(quotas[t]), 0), k, int((row != 0).sum()))
        upper = np.uint64(2**64 - 1)
        for done in range(0, r, cap):
            m = min(cap, r - done)
            thr = _radix_threshold(row, done + m)
            win = row[(row != 0) & (row >= thr) & (row < upper)]
            assert win.size == m          # exactly this chunk's winners
            win = np.sort(win)[::-1]
            cols[t, done:done + m] = (np.uint64(0xFFFFFFFF)
                                      - (win & np.uint64(0xFFFFFFFF)))
            take[t, done:done + m] = True
            upper = thr
        counts[t] = r
    return cols, take, counts


# The kernel's long route (csrc/selection.cu seg_topk_long_kernel, rows past
# the 24,576 lanes it stages), modelled in numpy: a row with quota <= 0 is not
# read; a 12-bit first digit over the row (the cluster's summed
# histograms); per chunk, further 12-bit digits over the row while the keys
# at or above the chosen bin, less the earlier chunks' winners, overflow the
# leader's candidate buffer; then the candidates, and the leader's digits
# over them down to the chunk's threshold (the same early stop; where one
# bin holds every key under the prefix, the next digit starts at the
# highest bit at which those keys differ). The kernel's block slices and
# staged keys change where a key is read, not which keys are counted, so
# the model has none.
LONG_BITS = 12


def _next_shift(sh):
    return sh - LONG_BITS if sh > LONG_BITS else 0


def _pick_digit(hist, above, need, n=None):
    """(digit, keys above it, keys in it): the bin that holds the need-th
    largest key; n sets ``above`` to n less the histogram's total."""
    if n is not None:
        above = n - int(hist.sum())
    top = above + np.cumsum(hist[::-1])          # keys at or above each bin
    i = int(np.argmax(top >= need))
    d = hist.size - 1 - i
    assert above < need <= top[-1]
    return d, int(top[i] - hist[d]), int(hist[d])


def _under(keys, P, sh):
    """The keys under prefix P (their bits from sh up)."""
    return keys[(keys >> np.uint64(sh)) == np.uint64(P)]


def _digit_hist(under, sh, sh2):
    """Histogram of the digit in bits [sh2, sh) of ``under``."""
    d = (under >> np.uint64(sh2)) & np.uint64((1 << (sh - sh2)) - 1)
    return np.bincount(d.astype(np.int64), minlength=1 << LONG_BITS)


def long_topk_model(score, valid, quotas, k, cap=2048, cands=8192):
    T, S = score.shape
    keys = _topk_keys(score, valid)
    cols = np.full((T, k), S, np.int32)
    take = np.zeros((T, k), bool)
    counts = np.zeros(T, np.int32)
    for t in range(T):
        if int(quotas[t]) <= 0:
            continue
        elig = keys[t][keys[t] != 0]
        first = np.bincount((elig >> np.uint64(64 - LONG_BITS)).astype(
            np.int64), minlength=1 << LONG_BITS)
        r = min(int(quotas[t]), k, int(first.sum()))
        upper = np.uint64(2**64 - 1)
        for done in range(0, r, cap):
            m = min(cap, r - done)
            need = done + m
            P, above, count = _pick_digit(first, 0, need)
            sh = 64 - LONG_BITS
            final = above + count == need
            while not final and above + count - done > cands:
                sh2 = _next_shift(sh)                 # over the row
                d, above, count = _pick_digit(
                    _digit_hist(_under(elig, P, sh), sh, sh2), above, need)
                P, sh = (P << (sh - sh2)) | d, sh2
                final = above + count == need or sh == 0
            lo = np.uint64(P << sh)
            cand = elig[(elig >= lo) & (elig < upper)]
            assert cand.size == above + count - done <= cands
            n, above = cand.size, None
            while not final:                          # the leader's
                sh2 = _next_shift(sh)
                under = _under(cand, P, sh)
                d, above, count = _pick_digit(
                    _digit_hist(under, sh, sh2), above, m,
                    n if above is None else None)
                P, sh = (P << (sh - sh2)) | d, sh2
                final = above + count == m or sh == 0
                if not final and count == under.size:     # one bin: ties
                    k_and = int(np.bitwise_and.reduce(under))
                    sh = (k_and ^ int(np.bitwise_or.reduce(under))
                          ).bit_length()
                    P = k_and >> sh
            thr = np.uint64(P << sh)
            win = np.sort(cand[cand >= thr])[::-1]
            assert win.size == m              # exactly this chunk's winners
            cols[t, done:done + m] = (np.uint64(0xFFFFFFFF)
                                      - (win & np.uint64(0xFFFFFFFF)))
            take[t, done:done + m] = True
            upper = thr
        counts[t] = r
    return cols, take, counts


# the models' capacities: the staged route's sort (2,048, and 5: many
# chunks at small sizes); the long route's sort and candidate buffer
# (2,048 and 8,192, the kernel's; 3 and 5, so that the digits over the
# row run whenever a threshold bin holds more than a few keys)
TOPK_MODELS = {"2048": 2048, "5": 5, "long-8192": (2048, 8192),
               "long-5": (3, 5)}


@pytest.mark.parametrize("cap", list(TOPK_MODELS.values()),
                         ids=list(TOPK_MODELS))
@pytest.mark.parametrize("case", [f"seed{i}" for i in range(10)]
                         + list(TOPK_EDGE_CASES))
def test_seg_topk_radix_model_matches_plain(case, cap):
    """The kernel's two routes, each at its capacities and at capacities of
    a few keys, bitwise against the plain version on the seeded grid and
    the edge cases the card-only tests use: the staged route's radix
    select, and the long route's first digit, candidate buffer, digits
    over the row when the buffer overflows, and chunks."""
    if case.startswith("seed"):
        score, valid, quotas, k = topk_case(int(case[4:]))
        k = max(min(k, score.shape[1]), 1)
    else:
        score, valid, quotas, k = topk_edge_case(case)
    want = TSEL_REF.seg_topk_ref(torch.as_tensor(score),
                                 torch.as_tensor(valid),
                                 torch.as_tensor(quotas), k)
    if isinstance(cap, tuple):
        got = long_topk_model(score, valid, quotas, k, *cap)
    else:
        got = radix_topk_model(score, valid, quotas, k, cap=cap)
    for name, g, w in zip(("cols", "take", "counts"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


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


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("values", ["mask", "full"])
@pytest.mark.parametrize("shape", SUMS_CARD_SHAPES)
def test_seg_sums_card_shapes_match_reference(shape, values, impl):
    """K3's plain version against the reference at the card tests' shapes
    (C1's width, unaligned rows, S=1, T=1, a long row, T=200)."""
    x, valid = sums_card_case(shape, values)
    _eq(TSEL.seg_sums(torch.as_tensor(x), torch.as_tensor(valid)),
        j_seg_sums(jnp.asarray(x), jnp.asarray(valid), impl=impl), "sums")


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("values", ["mask", "full"])
@pytest.mark.parametrize("shape", SUMS_CARD_SHAPES)
def test_seg_reduce_card_shapes_match_reference(shape, values, impl):
    """K2's plain version (sums and exclusive prefix) against the reference
    at the card tests' shapes: C1's width, unaligned rows, S=1, T=1, a long
    row, T=200; 0/1 values and full-range values whose sums wrap."""
    x, valid = sums_card_case(shape, values)
    js, jp = j_seg_reduce(jnp.asarray(x), jnp.asarray(valid), impl=impl)
    ts, tp = TSEL.seg_reduce(torch.as_tensor(x), torch.as_tensor(valid))
    _eq(ts, js, "sums")
    _eq(tp, jp, "prefix")


# K2's partition (csrc/selection.cu seg_reduce_kernel), modelled in numpy:
# thread r of 1,024 owns a run of 4-lane units; the lanes before x's first
# 16-byte boundary go to thread 0 ahead of its run, the ragged tail to the
# last thread after its run; rows whose x and valid are out of phase go
# lane by lane in runs. px / pv: the row's x phase in elements and valid
# phase in bytes, modulo 4.
REDUCE_THREADS = 1024


def seg_reduce_runs(S, px, pv, n=REDUCE_THREADS):
    """Each thread's lanes, in the order the thread adds them."""
    if px != pv:
        run = -(-S // n)
        return [np.arange(min(r * run, S), min(r * run + run, S))
                for r in range(n)]
    head = min((4 - px) & 3, S)
    units = (S - head) >> 2
    run = -(-units // n)
    tail = head + 4 * units
    out = []
    for r in range(n):
        u0 = min(r * run, units)
        u1 = min(u0 + run, units)
        lanes = [np.arange(head) if r == 0 else np.arange(0),
                 head + np.arange(4 * u0, 4 * u1),
                 np.arange(tail, S) if r == n - 1 else np.arange(0)]
        out.append(np.concatenate(lanes).astype(np.int64))
    return out


def seg_reduce_model(x, valid, x_off=0, v_off=0):
    """(sums, prefix) as the kernel computes them: per-thread run totals in
    uint32, one exclusive scan over the threads, then each run's lanes."""
    T, S = x.shape
    sums = np.zeros(T, np.int32)
    prefix = np.zeros((T, S), np.int32)
    xm = np.where(valid, x, 0).astype(np.int64).astype(np.uint32)
    for t in range(T):
        runs = seg_reduce_runs(S, (x_off + t * S) % 4, (v_off + t * S) % 4)
        order = np.concatenate(runs)
        np.testing.assert_array_equal(order, np.arange(S))  # each lane once
        tot = np.array([xm[t, r].sum(dtype=np.uint32) for r in runs],
                       np.uint32)
        base = np.concatenate([[0], np.cumsum(tot, dtype=np.uint32)[:-1]]
                              ).astype(np.uint32)
        for r, lanes in enumerate(runs):
            inc = np.cumsum(xm[t, lanes], dtype=np.uint32)
            prefix[t, lanes] = (base[r] + inc - xm[t, lanes]).view(np.int32)
        sums[t] = np.uint32(tot.sum(dtype=np.uint32)).view(np.int32)
    return sums, prefix


@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (1, 0), (0, 2)])
@pytest.mark.parametrize("shape", [(3, 4096), (5, 4097), (4, 4093), (3, 1),
                                   (1, 262144), (3, 3000), (2, 7)])
def test_seg_reduce_partition_model_matches_reference(shape, offsets):
    """The kernel's runs cover every lane once, in order, for every phase
    of x and valid, and their uint32 totals, scan and prefixes equal the
    reference's on full-range values whose sums wrap."""
    x, valid = sums_card_case(shape, "full")
    js, jp = j_seg_reduce(jnp.asarray(x), jnp.asarray(valid), impl="ref")
    ms, mp = seg_reduce_model(x, valid, *offsets)
    np.testing.assert_array_equal(ms, np.asarray(js))
    np.testing.assert_array_equal(mp, np.asarray(jp))


# --------------------------------------------------------- commit_moves ----
def _moves_case(case):
    """A seeded small case (an int) or a card case by name."""
    return (moves_case(case) if isinstance(case, int)
            else moves_card_case(case))


MOVES_CASES = [*range(8), *MOVES_CARD_CASES]


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("seed", MOVES_CASES)
def test_commit_moves_matches_reference(seed, impl):
    (tier, data, head, pages, take, tenants, hot, t, direction,
     to_tier) = _moves_case(seed)
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


# The CUDA kernel's partition (csrc/selection.cu commit_moves_kernel),
# modelled in numpy so that its offset arithmetic is pinned where no kernel
# runs: one thread per 16 lanes on up to 16 blocks of 64 threads (one
# cluster), then longer runs; each run's count, one exclusive scan of the
# counts (within each block, then over the block totals; the total with
# it), the kept window [total - C, total) and the slot floor_mod(head +
# off, C) in int32, taken once a run and then stepped by one.
MOVE_GROUP, MOVE_THREADS, MOVE_CLUSTER = 16, 64, 16


def moves_partition(N: int):
    """(blocks, run) of the launch for an N-lane stream."""
    groups = -(-N // MOVE_GROUP)
    blocks = min(max(-(-groups // MOVE_THREADS), 1), MOVE_CLUSTER)
    return blocks, MOVE_GROUP * max(1, -(-groups // (blocks * MOVE_THREADS)))


def commit_moves_model(tier, data, head, pages, take, tenants, hot_bits, t,
                       direction, to_tier):
    L, C, N = tier.shape[0], data.shape[0], take.shape[0]
    blocks, run = moves_partition(N)
    lo = np.minimum(np.arange(blocks * MOVE_THREADS) * run, N)
    hi = np.minimum(lo + run, N)
    counts = np.array([int(take[a:b].sum()) for a, b in zip(lo, hi)]
                      ).reshape(blocks, MOVE_THREADS)
    within = np.cumsum(counts, axis=1) - counts      # the block scan
    block_totals = counts.sum(axis=1)
    block_base = np.cumsum(block_totals) - block_totals   # over the cluster
    base = (block_base[:, None] + within).reshape(-1)
    total = int(block_totals.sum())
    keep_from = total - C
    tier, ring = tier.copy(), data.copy()
    stored_slots = set()

    def wrap(v):
        return (v + 2**31) % 2**32 - 2**31

    for r in range(blocks * MOVE_THREADS):
        off, slot = int(base[r]), None
        for i in np.flatnonzero(take[lo[r]:hi[r]]) + lo[r]:
            page = int(pages[i])
            if 0 <= page < L:       # a page taken twice stores one value
                tier[page] = to_tier
            if off >= keep_from:
                slot = (wrap(int(head) + off) % C if slot is None
                        else (slot + 1) % C)         # floor mod, then step
                assert slot not in stored_slots      # no two rows, one slot
                stored_slots.add(slot)
                ring[slot] = (t, tenants[i], page, direction, hot_bits[i])
            off += 1
    return tier, ring, np.int32(wrap(int(head) + total))


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("case", MOVES_CASES)
def test_commit_moves_partition_model_matches_reference(case, impl):
    """The kernel's runs, scan, keep window and slots, bitwise against the
    reference's commit_moves on the seeded grid and the card cases (N =
    16,384 over and under the ring, nothing taken, 16,383, 16,385,
    131,072, heads near 2**31 - 1, C = 1)."""
    (tier, data, head, pages, take, tenants, hot, t, direction,
     to_tier) = _moves_case(case)
    want = j_commit_moves(jnp.asarray(tier), jnp.asarray(data),
                          jnp.asarray(head), jnp.asarray(pages),
                          jnp.asarray(take), jnp.asarray(tenants),
                          jnp.asarray(hot), jnp.asarray(np.int32(t)),
                          direction=direction, to_tier=to_tier, impl=impl)
    got = commit_moves_model(tier, data, head, pages, take, tenants,
                             hot.view(np.int32), t, direction, to_tier)
    for name, g, w in zip(("tier", "ring_data", "head"), got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("N,blocks,run", [
    (1, 1, 16), (33, 1, 16), (2000, 2, 16), (16384, 16, 16), (16383, 16, 16),
    (16385, 16, 32), (131072, 16, 128)])
def test_commit_moves_partition_sizes(N, blocks, run):
    """One 16-lane run a thread on up to 16 blocks of 64 threads, then
    longer runs: the runs always cover the stream, so one scan serves any
    N."""
    assert moves_partition(N) == (blocks, run)
    assert run % 16 == 0 and blocks * MOVE_THREADS * run >= N


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


# The CUDA kernel's algorithm (csrc/serving.cu pool_attention_split_kernel
# and pool_attention_merge_kernel), modelled in torch so that its logic is
# pinned where no kernel runs: splits of contiguous slots, the list of
# valid slots with their token ranges, each warp walking entries w, w + 4,
# ... in units of up to 16 tokens with its own online softmax, page masses
# following the warp's running max, the warps merged in order, then the
# splits merged.
def split_partial_model(q, pool_k, pool_v, slot_page, seq_len, *, window,
                        splits, warps=TTA_K.WARPS, unit=TTA_K.UNIT):
    B, Mp, pt, K, D = pool_k.shape
    H = q.shape[1]
    G = H // K
    neg = TTA_REF.NEG_INF
    per = -(-Mp // splits)
    n = -(-Mp // per)
    acc_p = torch.zeros((n, B, H, D))
    m_p = torch.full((n, B, H), neg)
    l_p = torch.zeros((n, B, H))
    mass = torch.zeros((B, H, Mp))
    for b in range(B):
        seq = int(seq_len[b])
        for kk in range(K):
            hs = slice(kk * G, (kk + 1) * G)
            qg = q[b, hs].float() / np.sqrt(D)                     # [G, D]
            for s in range(n):
                p0, p1 = s * per, min(Mp, (s + 1) * per)
                ents = []
                for p in range(p0, p1):
                    page = int(slot_page[b, p])
                    if page < 0:
                        continue
                    hi = min(max(seq - page * pt + 1, 0), pt)
                    lo = (min(max(seq - window - page * pt + 1, 0), pt)
                          if window is not None else 0)
                    if hi > lo:
                        ents.append((p, lo, hi))
                mass_s = torch.zeros((G, p1 - p0))
                stab = torch.full((G, p1 - p0), neg)
                m_w = torch.full((warps, G), neg)
                l_w = torch.zeros((warps, G))
                acc_w = torch.zeros((warps, G, D))
                for w in range(warps):
                    m, l, acc = m_w[w], l_w[w], acc_w[w]
                    for p, lo, hi in ents[w::warps]:
                        for k in range(lo // unit, (hi - 1) // unit + 1):
                            rows = slice(max(lo, k * unit),
                                         min(hi, (k + 1) * unit))
                            kr = pool_k[b, p, rows, kk].float()
                            vr = pool_v[b, p, rows, kk].float()
                            sc = qg @ kr.T                          # [G, n]
                            m_new = torch.maximum(m, sc.amax(dim=1))
                            pr = torch.exp(sc - m_new[:, None])
                            usum = pr.sum(dim=1)
                            corr = torch.exp(m - m_new)
                            l = l * corr + usum
                            acc = acc * corr[:, None] + pr @ vr
                            m = m_new
                            mpage = (usum if k == lo // unit
                                     else mpage * corr + usum)
                        mass_s[:, p - p0] = mpage
                        stab[:, p - p0] = m
                    m_w[w], l_w[w], acc_w[w] = m, l, acc
                m = m_w.amax(dim=0)
                c = torch.exp(m_w - m)                              # [W, G]
                mass[b, hs, p0:p1] = mass_s * torch.exp(stab - m[:, None])
                acc_p[s, b, hs] = (acc_w * c[..., None]).sum(0)
                m_p[s, b, hs], l_p[s, b, hs] = m, (l_w * c).sum(0)
    if n == 1:
        return acc_p[0], m_p[0], l_p[0], mass
    m = m_p.amax(dim=0)
    c = torch.exp(m_p - m)                                          # [n,B,H]
    owner = torch.arange(Mp) // per
    return ((acc_p * c[..., None]).sum(0), m, (l_p * c).sum(0),
            mass * c.permute(1, 2, 0)[:, :, owner])


def split_case(name):
    """Pool-partial inputs for the split model: (q [B,H,D], pool_k, pool_v,
    slot_page, seq_len) of one pool. "attn<i>_<fast|slow>" are the seeded
    ATTN_SHAPES pools; "ragged" has Mp = 13 (not a multiple of the splits'
    length), slots 3-5 free (the second of five splits holds only free
    slots) and pages in shuffled slots; "zamba2" has D = 112 with G = 1;
    "long_pages" has pages of 32 tokens (two units a page) and G = 8 (two
    head groups)."""
    if name.startswith("attn"):
        i, pool = name[4:].split("_")
        q, fk, fv, sk, sv, fp, sp, seq_len = attention_case(
            ATTN_SHAPES[int(i)])
        pk, pv, page = (fk, fv, fp) if pool == "fast" else (sk, sv, sp)
        return q[:, 0], pk, pv, page, seq_len
    B, H, K, D, Mp, pt = {"ragged": (2, 8, 4, 64, 13, 8),
                          "zamba2": (2, 4, 4, 112, 10, 16),
                          "long_pages": (2, 16, 2, 32, 6, 32)}[name]
    rng = np.random.default_rng(15)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pk, pv = (rng.standard_normal((B, Mp, pt, K, D)).astype(np.float32)
              for _ in range(2))
    page = np.stack([rng.permutation(Mp) for _ in range(B)]).astype(np.int32)
    if name == "ragged":
        page[:, 3:6] = -1
    seq_len = np.array([Mp * pt - 5, (Mp - 2) * pt + 3], np.int32)
    return q, pk, pv, page, seq_len


SPLIT_CASES = [f"attn{i}_{pool}" for i in range(len(ATTN_SHAPES))
               for pool in ("fast", "slow")] + ["ragged", "zamba2",
                                                "long_pages"]


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("window", [None, 40])
def test_pool_attention_split_model_matches_plain(case, splits, window):
    """The kernel's split partials and merge within 1e-5 of the plain
    version, and within the existing 2e-5 of the reference's Pallas kernel
    in interpret mode (its masses rescaled from their per-block stabilisers
    to the final m): 1, 2 and 5 splits, a split with only free slots,
    window 40 cutting whole pages, Mp not a multiple of the split's length,
    D = 112 with G = 1, pages of two units."""
    q, pk, pv, page, seq_len = split_case(case)
    got = split_partial_model(
        torch.as_tensor(q), torch.as_tensor(pk), torch.as_tensor(pv),
        torch.as_tensor(page), torch.as_tensor(seq_len), window=window,
        splits=splits)
    want = TTA_REF.pool_attention_partial_ref(
        *(torch.as_tensor(a) for a in (q, pk, pv, page, seq_len)),
        window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    Mp = pk.shape[1]
    blk = max(d for d in range(1, 9) if Mp % d == 0)
    acc, m, l, mass, stab = j_partial_tpu(
        *(jnp.asarray(a) for a in (q, pk, pv, page, seq_len)),
        window=window, page_block=blk, interpret=True)
    mass = np.asarray(mass) * np.exp(
        np.repeat(np.asarray(stab), blk, axis=-1) - np.asarray(m)[..., None])
    for g, w in zip(got, (acc, m, l, mass)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-5)


def test_pool_attention_split_policy():
    """One split at the serving paths' widths (Llama 3.2 1B: 64 sequences x
    8 kv heads; Zamba2-7B: 32 x 32), several for a small batch, none
    shorter than a page per warp, at most 32."""
    assert TTA_K.num_splits(64, 8, 32) == (1, 32)
    assert TTA_K.num_splits(64, 8, 16) == (1, 16)
    assert TTA_K.num_splits(32, 32, 16) == (1, 16)
    assert TTA_K.num_splits(1, 8, 64) == (16, 4)
    assert TTA_K.num_splits(1, 8, 40) == (10, 4)
    assert TTA_K.num_splits(2, 4, 13) == (3, 5)
    assert TTA_K.num_splits(2, 4, 3) == (1, 3)
    assert TTA_K.num_splits(1, 1, 4096) == (32, 128)


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


def _pair_case(shape):
    src, dst, si, di, sel = migrate_case(shape)
    return (src, dst, src[::-1].copy(), dst[::-1].copy(),
            migrate_index_cases(si, di, sel, shape[2], shape[3]))


# The reference's plain version and its kernel disagree on indices out of
# the pools: the jnp gather wraps negative indices and its scatter drops a
# destination past the end, while the Pallas kernel clamps both
# (``jnp.maximum(idx, 0)`` and the block index), as the port's kernels do.
# The serving path never hands either an index out of range; those cases
# are held against the kernel (interpret mode) only.
def _jax_impls(case):
    return ("pallas_interpret",) if case == "out_of_range" else JAX_IMPLS


@pytest.mark.parametrize("case", ["seeded", "same_slot", "none",
                                  "out_of_range"])
@pytest.mark.parametrize("shape", MIGRATE_SHAPES + MIGRATE_ODD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_migrate_pages_kv_matches_reference(shape, dtype, case):
    """The K+V pair wrapper's plain version against two reference
    migrate_pages calls, bitwise and in place, on pages not a multiple of
    16 bytes, more sequences than one block compacts, source slot ==
    destination slot, nothing selected and indices out of range."""
    src_k, dst_k, src_v, dst_v, idx = _pair_case(shape)
    s_i, d_i, se = idx[case]
    tdt = getattr(torch, dtype)
    t_dst = [torch.as_tensor(a).to(tdt) for a in (dst_k, dst_v)]
    got = TMIG.migrate_pages_kv(torch.as_tensor(src_k).to(tdt), t_dst[0],
                                torch.as_tensor(src_v).to(tdt), t_dst[1],
                                *(torch.as_tensor(a) for a in (s_i, d_i, se)))
    assert got[0] is t_dst[0] and got[1] is t_dst[1]     # in place
    for impl in _jax_impls(case):
        for g, src, dst in zip(got, (src_k, src_v), (dst_k, dst_v)):
            want = j_migrate_pages(jnp.asarray(src, dtype),
                                   jnp.asarray(dst, dtype), jnp.asarray(s_i),
                                   jnp.asarray(d_i), jnp.asarray(se),
                                   impl=impl)
            np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                          np.asarray(want, np.float32))


# K6's work items (csrc/serving.cu migrate_pages_kernel), modelled in numpy:
# a grid of 2 blocks per SM (132 SMs), capped by the most work; each block
# compacts the selected sequences of windows of 128 in order and walks the
# items (pool, layer, selected sequence, 16 KiB chunk) in a grid-stride loop.
COPY_CHUNK, COPY_THREADS, COPY_GRID = 16384, 128, 2 * 132


def migrate_items_model(pairs, si, di, sel):
    """Copies each item's bytes from source to destination (numpy arrays,
    updated in place) and returns the items in the order blocks take
    them; asserts no item is taken twice."""
    L, B, Ms = pairs[0][0].shape[:3]
    Md = pairs[0][1].shape[2]
    page = pairs[0][0][0, 0, 0].nbytes
    nch = -(-page // COPY_CHUNK)
    grid = min(COPY_GRID, len(pairs) * L * B * nch)
    views = [(s.reshape(L, B * Ms, page // s.itemsize).view(np.uint8),
              d.reshape(L, B * Md, page // d.itemsize).view(np.uint8))
             for s, d in pairs]
    seen = set()
    for w0 in range(0, B, COPY_THREADS):
        b = np.arange(w0, min(w0 + COPY_THREADS, B))
        b = b[sel[b] != 0]
        rows = list(zip(b * Ms + np.clip(si[b], 0, Ms - 1),
                        b * Md + np.clip(di[b], 0, Md - 1)))
        items = len(pairs) * L * len(rows) * nch
        for blk in range(grid):
            for it in range(blk, items, grid):
                c, t = it % nch, it // nch
                j, t = t % len(rows), t // len(rows)
                lay, p = t % L, t // L
                key = (p, lay, int(b[j]), c)
                assert key not in seen
                seen.add(key)
                lo, hi = c * COPY_CHUNK, min(page, (c + 1) * COPY_CHUNK)
                s, d = views[p]
                d[lay, rows[j][1], lo:hi] = s[lay, rows[j][0], lo:hi]
    return seen


@pytest.mark.parametrize("case", ["seeded", "same_slot", "none",
                                  "out_of_range"])
@pytest.mark.parametrize("shape", MIGRATE_SHAPES + MIGRATE_ODD_SHAPES
                         + MIGRATE_CARD_SHAPES)
def test_migrate_items_model_matches_reference(shape, case):
    """The kernel's items cover every selected page of both pools once
    (float32 pages of one chunk and a part, of 14 chunks at S3's widths;
    300 sequences in three windows) and reproduce two reference
    migrate_pages calls. The model copies bytes, so float32 pools stand
    for bf16 ones."""
    src_k, dst_k, src_v, dst_v, idx = _pair_case(shape)
    s_i, d_i, se = idx[case]
    got = [dst_k.copy(), dst_v.copy()]
    seen = migrate_items_model([(src_k, got[0]), (src_v, got[1])], s_i, d_i,
                               se)
    nch = -(-src_k[0, 0, 0].nbytes // COPY_CHUNK)
    assert len(seen) == 2 * shape[0] * int((se != 0).sum()) * nch
    for impl in _jax_impls(case):
        for g, src, dst in zip(got, (src_k, src_v), (dst_k, dst_v)):
            want = j_migrate_pages(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(s_i), jnp.asarray(d_i),
                                   jnp.asarray(se), impl=impl)
            np.testing.assert_array_equal(g, np.asarray(want))
