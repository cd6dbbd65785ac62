"""Tenant-batched selection & reduction primitives (torch port of
``repro/core/select.py``).

The tick repeatedly needs "take the `quota[t]` best pages of every tenant t"
(demotion picks coldest-first, promotion hottest-first), "rank each
tenant's new pages in index order" (allocation gating), and per-tenant sums.

* **contiguous layout** (what ``core/workloads.build_trace`` produces:
  tenant t owns pages [bounds[t], bounds[t+1])): selection is a gather into
  padded [T, S] rows plus one batched masked top-k, and per-tenant sums are
  row reductions.
* **arbitrary owner vectors** (a permuted static owner, or ownership as
  state under churn, with the free-pool sentinel ``T``): ranks come from
  one lexicographic sort (``segment_ranks``/``select_top_quota``) and sums
  from scatter-adds (``by_tenant_scatter``/``by_tenant_pooled``).

Ties go (score desc, index asc), the ``jax.lax.top_k`` rule; ``torch.topk``
makes no such promise, so top-k is a stable descending sort. JAX's
``mode="drop"`` scatters become scatters into a scratch slot past the end.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.migrate import ops as KMIG
from repro_torch.kernels.migrate import ref as KMIG_REF
from repro_torch.kernels.select import ops as KSEL
from repro_torch.kernels.select import ref as KSEL_REF
from repro_torch.kernels.select.ref import top_k


class Selection(NamedTuple):
    """Result of a per-tenant quota selection.

    ``mask`` is always present. The compact fields are set by the
    contiguous-rows strategies: they expose the [T, k] candidate stream so
    downstream accounting (migration ring, residency histograms, thrash
    table) runs over T*k lanes instead of L."""
    mask: torch.Tensor                  # [L] bool: selected pages
    pages: Optional[torch.Tensor]       # [T, k] int32 page ids (or None)
    take: Optional[torch.Tensor]        # [T, k] bool: lane actually selected
    counts: Optional[torch.Tensor]      # [T] int32: selected per tenant


def _scatter_mask(flat: torch.Tensor, L: int) -> torch.Tensor:
    """[L] bool mask with True at ``flat`` (entries equal to L dropped)."""
    out = torch.zeros((L + 1,), dtype=torch.bool, device=flat.device)
    out.index_fill_(0, flat.reshape(-1).to(torch.int64), True)
    return out[:L]


# ------------------------------------------------------ contiguous layout ----
class ContiguousLayout(NamedTuple):
    """Description of a contiguous ownership layout (built once per owner)."""
    n_tenants: int
    n_pages: int
    row_page: torch.Tensor    # [T, S] int32 page id per tenant row (pads 0)
    row_valid: torch.Tensor   # [T, S] bool
    bounds: torch.Tensor      # [T+1] int64: tenant t owns [bounds[t], bounds[t+1])
    page_start: torch.Tensor  # [L] int64: segment start of each page's tenant


def plan_layout(owner: np.ndarray, n_tenants: int, device="cuda"
                ) -> Optional[ContiguousLayout]:
    """Build the layout if ``owner`` is sorted-contiguous, else None."""
    device = resolve_device(device)
    owner = np.asarray(owner)
    counts = np.bincount(owner, minlength=n_tenants)
    if counts.shape[0] > n_tenants:
        return None
    if not np.array_equal(owner, np.repeat(np.arange(n_tenants), counts)):
        return None
    L = owner.shape[0]
    S = max(int(counts.max()) if counts.size else 0, 1)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    col = np.arange(S)[None, :]
    row_page = bounds[:-1, None] + col
    row_valid = col < counts[:, None]
    row_page = np.where(row_valid, row_page, 0).astype(np.int32)
    return ContiguousLayout(
        n_tenants=n_tenants, n_pages=L,
        row_page=torch.as_tensor(row_page, device=device),
        row_valid=torch.as_tensor(row_valid, device=device),
        bounds=torch.as_tensor(bounds, device=device),
        page_start=torch.as_tensor(bounds[owner], device=device))


def select_top_quota_rows(score: torch.Tensor, active: torch.Tensor,
                          quotas: torch.Tensor, layout: ContiguousLayout,
                          k_cap: int) -> Selection:
    """Contiguous-layout quota select: gather to [T, S] rows, one batched
    masked top-k, scatter the winners back."""
    L = layout.n_pages
    T, S = layout.row_page.shape
    rp = layout.row_page.to(torch.int64)
    s2 = torch.where(layout.row_valid & active[rp], score[rp],
                     float("-inf"))
    k = min(k_cap, S)
    vals, cols = top_k(s2, k)
    lane = torch.arange(k, device=score.device)
    take = (lane[None, :] < quotas[:, None]) & torch.isfinite(vals)
    pages = torch.gather(layout.row_page, 1, cols)
    mask = _scatter_mask(torch.where(take, pages, L), L)
    return Selection(mask=mask, pages=pages, take=take,
                     counts=take.sum(dim=1, dtype=torch.int32))


def by_tenant_contiguous(x: torch.Tensor,
                         layout: ContiguousLayout) -> torch.Tensor:
    """Per-tenant sum, O(L), no scatter.

    Integers sum associatively: a row gather + axis reduce. Floats keep the
    reference's cumsum + boundary-gather association (the reference pins
    its f32 perf-model reductions this way), accumulated in float64 and
    rounded once: a float32 scan on the card may take its adds in another
    order from one run to the next (a decoupled look-back scan), and the
    cancellation in ``cs[end] - cs[start]`` over L=262,144 pages magnifies
    that past rtol 1e-5."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    if not x.is_floating_point():
        rows = torch.where(layout.row_valid,
                           x[layout.row_page.to(torch.int64)], 0)
        return rows.sum(dim=1, dtype=x.dtype)
    cs = torch.cat([x.new_zeros(1, dtype=torch.float64),
                    torch.cumsum(x.to(torch.float64), 0)])
    return (cs[layout.bounds[1:]] - cs[layout.bounds[:-1]]).to(x.dtype)


def allocation_ranks_contiguous(new: torch.Tensor,
                                layout: ContiguousLayout) -> torch.Tensor:
    """Index-order rank of each new page among its tenant's new pages:
    exclusive cumsum minus the value at the segment start."""
    L = new.shape[0]
    cs0 = torch.cat([new.new_zeros(1, dtype=torch.int32),
                     torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32)])
    return cs0[:L] - cs0[layout.page_start]


def masked_rank(mask: torch.Tensor) -> torch.Tensor:
    """Rank of each True element among True elements (by index order)."""
    m = mask.to(torch.int32)
    return torch.cumsum(m, 0, dtype=torch.int32) - m


def select_global(score: torch.Tensor, mask: torch.Tensor, quota,
                  k_max: int) -> torch.Tensor:
    """Tenant-blind top-quota select (the TPP baseline's global scan)."""
    L = score.shape[0]
    k = min(k_max, L)
    s = torch.where(mask, score, float("-inf"))
    vals, idx = top_k(s, k)
    take = (torch.arange(k, device=score.device) < quota) \
        & torch.isfinite(vals)
    return torch.zeros((L,), dtype=torch.bool,
                       device=score.device).scatter(0, idx, take)


# ------------------------------------------------------- generic (sorted) ----
def segment_ranks(seg: torch.Tensor, key: Optional[torch.Tensor],
                  n_seg: int) -> torch.Tensor:
    """Within-segment rank of every element, ordered by (key asc, index asc).

    seg: [L] int segment id in [0, n_seg]; ``n_seg`` is the sentinel for
    inactive elements (they still get ranks, callers never select them).
    The reference sorts (seg, key) with ``lax.sort``, which orders -0.0 and
    +0.0 as equal and keeps index order on ties; two stable sorts (key,
    then segment) give the same order, and ``torch.sort`` also treats the
    two zeros as equal. ``key=None`` is the reference's all-zero key:
    index order, one stable sort."""
    L = seg.shape[0]
    seg = seg.to(torch.int64)
    if key is None:
        order = torch.sort(seg, stable=True).indices
    else:
        by_key = torch.sort(key, stable=True).indices
        order = by_key[torch.sort(seg[by_key], stable=True).indices]
    counts = torch.zeros((n_seg + 1,), dtype=torch.int64,
                         device=seg.device).index_add_(
        0, seg, torch.ones_like(seg))
    starts = torch.cumsum(counts, 0) - counts          # exclusive prefix sum
    rank_sorted = torch.arange(L, device=seg.device) - starts[seg[order]]
    return torch.empty((L,), dtype=torch.int32, device=seg.device
                       ).index_copy_(0, order, rank_sorted.to(torch.int32))


def select_top_quota(score: torch.Tensor, owner: torch.Tensor,
                     active: torch.Tensor, quotas: torch.Tensor,
                     n_tenants: int, k_cap: int) -> torch.Tensor:
    """Select up to quotas[t] highest-score active elements of each tenant
    for an arbitrary owner permutation (one composite sort). The per-tenant
    take is capped at ``min(k_cap, L)``; non-finite scores are never
    selected. Returns the selection mask [L] bool."""
    L = score.shape[0]
    active = active & torch.isfinite(score)
    seg = torch.where(active, owner.to(torch.int64), n_tenants)
    ranks = segment_ranks(seg, -score, n_tenants)
    q = torch.clamp(quotas.to(torch.int32), max=min(k_cap, L))
    q_ext = torch.cat([q, q.new_zeros(1)])
    return active & (ranks < q_ext[seg])


def _scatter_sum(x: torch.Tensor, owner: torch.Tensor,
                 n_bins: int) -> torch.Tensor:
    """[n_bins] sums of ``x`` by ``owner``. Integers add exactly in any
    order; floats accumulate in float64 and round once, so the atomics of a
    card's ``index_add_`` leave them (nearly always) bitwise and always
    within float32 rounding of the reference's in-order float32 sum. The
    float sums feed only the perf model, never a decision."""
    acc = torch.float64 if x.is_floating_point() else x.dtype
    out = torch.zeros((n_bins,), dtype=acc, device=x.device).index_add_(
        0, owner.to(torch.int64), x.to(acc))
    return out.to(x.dtype)


def by_tenant_scatter(x: torch.Tensor, owner: torch.Tensor,
                      n_tenants: int) -> torch.Tensor:
    """Per-tenant sum for arbitrary owner vectors (scatter-add)."""
    return _scatter_sum(x, owner, n_tenants)


def by_tenant_pooled(x: torch.Tensor, owner: torch.Tensor,
                     n_tenants: int) -> torch.Tensor:
    """Per-tenant sum tolerant of the free-pool sentinel ``owner ==
    n_tenants``: sentinel lanes land in a scratch bucket."""
    return _scatter_sum(x, owner, n_tenants + 1)[:n_tenants]


def pool_grant(free_mask: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """Partition the free pool among tenants requesting pages (churn grant).

    free_mask: [L] bool pages in the free pool; need: [T] int32 pages each
    tenant wants granted this tick. Free pages are ranked in index order and
    tenant t receives the rank interval ``[cumsum(need)[t-1],
    cumsum(need)[t])``. When the pool is over-subscribed the intervals run
    off its end: lower slot ids win, trailing tenants get partial or empty
    grants. Returns [L] int32: the granted tenant per page, or ``T`` (the
    FREE sentinel) where no grant happens."""
    T = need.shape[0]
    rank = masked_rank(free_mask)
    cum = torch.cumsum(need.to(torch.int32), 0, dtype=torch.int32)
    tenant = torch.searchsorted(cum, rank, right=True, out_int32=True)
    granted = free_mask & (rank < cum[-1]) & (tenant < T)
    return torch.where(granted, tenant, T)


def allocation_ranks(new: torch.Tensor, owner: torch.Tensor,
                     n_tenants: int) -> torch.Tensor:
    """Index-order rank of each new page among its tenant's new pages,
    arbitrary owner vector. Values outside ``new`` are unspecified."""
    seg = torch.where(new, owner.to(torch.int64), n_tenants)
    return segment_ranks(seg, None, n_tenants)


# ------------------------------------------------------------------------
# Selection strategies: the seam between the tick core (core/tick.py) and
# the per-tenant primitives above.
# ------------------------------------------------------------------------
class Strategy(NamedTuple):
    """Owner-parameterized selection/reduction strategy for one tick flavor.

    by_tenant(x [L], owner [L]) -> [T] per-tenant sum
    select(score [L], owner [L], active [L], quotas [T]) -> Selection
    alloc_ranks(new [L], owner [L]) -> [L] index-order rank among the
        tenant's ``new`` pages (values outside ``new`` unspecified)

    The two optional members are fused-kernel upgrades (None on the
    "batched" strategy; the tick core falls back to its composed ops):

    alloc_stats(new [L], owner [L]) -> (ranks [L], counts [T])
    move(tier [L], ring_data [C,5], head, sel: Selection, hotv [L],
         direction, to_tier, t) -> (tier', ring_data', head') — commits a
        compact selection: tier scatter + migration-ring append in one
        kernel pass. May update ``tier``/``ring_data`` in place.
    """
    by_tenant: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    select: Callable[..., Selection]
    alloc_ranks: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    alloc_stats: Optional[Callable[..., tuple]] = None
    move: Optional[Callable[..., tuple]] = None


STRATEGY_IMPLS = ("batched", "ref", "cuda")


def _kernel_ops(impl: str):
    """(seg_topk, seg_reduce, seg_sums) for a kernel-backed strategy:
    "cuda" calls the kernel wrappers (``kernels/select/ops.py``), "ref" the
    kernels' plain torch versions on whatever device the tensors live."""
    if impl == "cuda":
        return KSEL.seg_topk, KSEL.seg_reduce, KSEL.seg_sums
    if impl == "ref":
        return (KSEL_REF.seg_topk_ref, KSEL_REF.seg_reduce_ref,
                KSEL_REF.seg_sums_ref)
    raise ValueError(f"kernel strategy impl must be 'cuda' or 'ref', "
                     f"got {impl!r}")


def static_strategy(owner: np.ndarray, n_tenants: int, k_max: int,
                    impl: str = "batched", device="cuda") -> Strategy:
    """Strategy for a constant owner vector.

    impl: "batched" is the plain mirror of the reference's jnp default
    (padded-row batched top-k and row reductions for a contiguous layout;
    one composite sort and scatter-adds for any other permutation); "cuda"
    and "ref" route the selection core through the kernel-backed strategy
    (``kernel_static_strategy``) on the hand-written kernels or on their
    plain torch versions."""
    if impl not in STRATEGY_IMPLS:
        raise ValueError(f"impl {impl!r} not in {STRATEGY_IMPLS}")
    device = resolve_device(device)
    if impl != "batched":
        return kernel_static_strategy(owner, n_tenants, k_max, impl, device)
    layout = plan_layout(owner, n_tenants, device)
    if layout is not None:
        def by_tenant(x, _owner):
            return by_tenant_contiguous(x, layout)

        def select(score, _owner, active, quotas):
            return select_top_quota_rows(score, active, quotas, layout,
                                         k_max)

        def alloc_ranks(new, _owner):
            return allocation_ranks_contiguous(new, layout)
        return Strategy(by_tenant, select, alloc_ranks)

    # arbitrary owner permutation: composite-sort ranks + scatter-adds
    T = n_tenants
    owner_t = torch.as_tensor(np.asarray(owner, np.int32), device=device)

    def by_tenant(x, _owner):
        return by_tenant_scatter(x, owner_t, T)

    def select(score, _owner, active, quotas):
        return Selection(
            select_top_quota(score, owner_t, active, quotas, T, k_max),
            None, None, None)

    def alloc_ranks(new, _owner):
        return allocation_ranks(new, owner_t, T)
    return Strategy(by_tenant, select, alloc_ranks)


def static_rows(owner: np.ndarray, n_tenants: int) -> np.ndarray:
    """[T, S] page-id rows (index order within tenant, -1 pads) for an
    arbitrary constant owner permutation."""
    owner = np.asarray(owner)
    L = owner.shape[0]
    counts = np.bincount(owner, minlength=n_tenants)[:n_tenants]
    S = max(int(counts.max()) if counts.size else 0, 1)
    rows = np.full((n_tenants, S), -1, np.int32)
    order = np.argsort(owner, kind="stable")
    seg = owner[order]
    starts = np.concatenate([[0], np.cumsum(counts)])
    rows[seg, np.arange(L) - starts[seg]] = order
    return rows


def _rows_select(seg_topk, score, active, quotas, rows64, valid_rows,
                 page_rows_pad, k: int, L: int, compact: bool) -> Selection:
    """Shared body: gather scores into [T, S] rows, run the segmented
    top-k, scatter winners back to an [L] mask. ``compact=False`` returns
    the mask only, the shape of the composite-sort path's Selection, so the
    [L]-lane accounting downstream (and the ring's event order) is the
    same as there."""
    elig = valid_rows & active[rows64]
    cols, take, counts = seg_topk(score[rows64].contiguous(), elig,
                                  quotas.to(torch.int32), k)
    pages = torch.gather(page_rows_pad, 1, cols.to(torch.int64))
    mask = _scatter_mask(torch.where(take, pages, L), L)
    if not compact:
        return Selection(mask, None, None, None)
    return Selection(mask=mask, pages=pages, take=take, counts=counts)


def kernel_static_strategy(owner: np.ndarray, n_tenants: int, k_max: int,
                           impl: str = "cuda", device="cuda") -> Strategy:
    """Kernel-backed strategy for a constant owner vector (the reference's
    ``pallas_static_strategy``).

    A contiguous layout gets segmented top-k selection, the fused rank+count
    reduction, per-row integer sums and the ``commit_moves`` page-move
    kernel over the compact [T, k] stream. Any other permutation runs the
    same kernels over a precomputed [T, S] rowspace but returns mask-only
    selections and no move, as the reference does. Float per-tenant sums
    stay on the reference's association (cumsum, or scatter) in both."""
    seg_topk, seg_reduce, seg_sums = _kernel_ops(impl)
    device = resolve_device(device)
    T = n_tenants
    owner_np = np.asarray(owner)
    L = owner_np.shape[0]
    owner64 = torch.as_tensor(owner_np, dtype=torch.int64, device=device)
    layout = plan_layout(owner_np, T, device)
    contiguous = layout is not None
    if contiguous:
        page_rows, valid_rows = layout.row_page, layout.row_valid
        col64 = torch.arange(L, dtype=torch.int64,
                             device=device) - layout.page_start
    else:
        rows_np = static_rows(owner_np, T)
        page_rows = torch.as_tensor(np.maximum(rows_np, 0), device=device)
        valid_rows = torch.as_tensor(rows_np >= 0, device=device)
        flat_rows = torch.where(valid_rows, page_rows, L).reshape(-1).to(
            torch.int64)
    rows64 = page_rows.to(torch.int64)
    S = page_rows.shape[1]
    k = max(min(k_max, S), 1)
    page_rows_pad = torch.cat(
        [torch.where(valid_rows, page_rows, L),
         torch.full((T, 1), L, dtype=torch.int32, device=device)], dim=1)

    def select(score, _owner, active, quotas):
        return _rows_select(seg_topk, score, active, quotas, rows64,
                            valid_rows, page_rows_pad, k, L,
                            compact=contiguous)

    def by_tenant(x, _owner):
        if x.is_floating_point():
            # the reference's f32 association: keep the jnp reduction order
            return (by_tenant_contiguous(x, layout) if contiguous
                    else by_tenant_scatter(x, owner64, T))
        return seg_sums(x.to(torch.int32)[rows64], valid_rows)

    def alloc_stats(new, _owner):
        sums, pre = seg_reduce(new.to(torch.int32)[rows64], valid_rows)
        if contiguous:
            return pre[owner64, col64], sums
        ranks = torch.zeros((L + 1,), dtype=torch.int32, device=new.device)
        ranks[flat_rows] = pre.reshape(-1)          # pads land on slot L
        return ranks[:L], sums

    def alloc_ranks(new, _owner):
        return alloc_stats(new, _owner)[0]

    if not contiguous:
        return Strategy(by_tenant, select, alloc_ranks, alloc_stats)

    def move(tier, ring_data, head, sel: Selection, hotv, direction, to_tier,
             t):
        tenants = torch.arange(T, dtype=torch.int32, device=tier.device
                               )[:, None].expand(sel.take.shape).reshape(-1)
        hot = hotv[torch.clamp(sel.pages, max=L - 1).to(torch.int64)]
        args = (tier, ring_data, head, sel.pages.reshape(-1),
                sel.take.reshape(-1), tenants)
        if impl == "cuda":
            return KMIG.commit_moves(*args, hot.reshape(-1), t,
                                     direction=direction, to_tier=to_tier)
        return KMIG_REF.commit_moves_ref(
            *args, hot.reshape(-1).contiguous().view(torch.int32), t,
            direction=direction, to_tier=to_tier)

    return Strategy(by_tenant, select, alloc_ranks, alloc_stats, move)


def dynamic_strategy(n_tenants: int, k_max: int, impl: str = "batched",
                     device="cuda") -> Strategy:
    """Strategy for ownership-as-state: the owner vector is a run-time
    tensor with the free-pool sentinel ``T``, so selection goes through the
    composite sort and sums through the sentinel-tolerant scatters. "cuda"
    and "ref" swap the selection step for the segmented top-k over a
    rowspace built each call (``kernel_dynamic_strategy``)."""
    if impl not in STRATEGY_IMPLS:
        raise ValueError(f"impl {impl!r} not in {STRATEGY_IMPLS}")
    device = resolve_device(device)
    if impl != "batched":
        return kernel_dynamic_strategy(n_tenants, k_max, impl, device)
    T = n_tenants

    def by_tenant(x, owner):
        return by_tenant_pooled(x, owner, T)

    def select(score, owner, active, quotas):
        return Selection(
            select_top_quota(score, owner, active, quotas, T, k_max),
            None, None, None)

    def alloc_ranks(new, owner):
        return allocation_ranks(new, owner, T)

    return Strategy(by_tenant, select, alloc_ranks)


def kernel_dynamic_strategy(n_tenants: int, k_max: int, impl: str = "cuda",
                            device="cuda",
                            s_max: Optional[int] = None) -> Strategy:
    """Kernel-backed strategy for ownership-as-state (the reference's
    ``pallas_dynamic_strategy``). Each selection rebuilds the [T, S]
    rowspace from the run-time owner vector (one index-order segment sort,
    then a scatter into rows), and the segmented top-k replaces the
    composite-key sort; reductions stay on the sentinel-tolerant scatters,
    selections are mask-only. S = L by default; ``s_max`` caps it at
    ``min(s_max, L)`` when the largest per-tenant footprint is known, and a
    page whose rank in its tenant is S or more is then dropped from the
    rowspace (it is never selected), as the reference's ``mode="drop"``
    scatter drops it."""
    seg_topk = _kernel_ops(impl)[0]
    resolve_device(device)
    T = n_tenants

    def by_tenant(x, owner):
        return by_tenant_pooled(x, owner, T)

    def select(score, owner, active, quotas):
        L = score.shape[0]
        S = min(s_max, L) if s_max else L
        seg = torch.where(owner < T, owner.to(torch.int64), T)
        col = segment_ranks(seg, None, T).to(torch.int64)
        # row T holds the free pool and column S the pages past the cap:
        # both are cut off below (torch's index assignment cannot drop)
        rows = torch.full((T + 1, S + 1), L, dtype=torch.int32,
                          device=owner.device)
        rows[seg, torch.clamp(col, max=S)] = torch.arange(
            L, dtype=torch.int32, device=owner.device)
        page_rows = rows[:T, :S]
        page_rows_pad = torch.cat(
            [page_rows, page_rows.new_full((T, 1), L)], dim=1)
        return _rows_select(seg_topk, score, active, quotas,
                            torch.clamp(page_rows, max=L - 1).to(torch.int64),
                            page_rows < L, page_rows_pad, min(k_max, S), L,
                            compact=False)

    def alloc_ranks(new, owner):
        return allocation_ranks(new, owner, T)

    return Strategy(by_tenant, select, alloc_ranks)
