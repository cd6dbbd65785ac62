"""Hotness providers: how the tick learns which pages are hot (torch port of
``repro/core/hotness.py``).

Hotness is a seam of ``core.tick.make_tick_core``: a provider owns an
optional state plus the update/candidate ops tick steps 3-6b consume, while
selection quotas, Eq.1/Eq.2 regulation, telemetry and churn run unchanged
on top.

  exact    — the dense [L] EWMA (the default).
  sampled  — the dense EWMA fed by a rotating per-tick page subset with
             unbiased 1/frac scaling.
  sketch   — a decayed count-min sketch over hashed page ids (core/cms.py)
             fed by O(probe) sampled lanes, plus per-tenant top-N
             candidate/victim buffers: the candidate paths touch O(hot
             set), not O(L).
  neomem   — an emulated device-side tracker counts every access and
             publishes a per-tenant top-N report each tick; the promotion
             path consumes it one tick late, demotion keeps the dense LRU.

The sketch's probe draw outside full coverage is ``jax.random``'s, bit for
bit (core/threefry.py), so its lanes are the reference's on any device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core import cms as CM
from repro_torch.core import select as SEL
from repro_torch.core import threefry as TF
from repro_torch.core.state import TIER_SLOW
from repro_torch.device import resolve_device
from repro_torch.kernels.select.ref import top_k
from repro_torch.numerics import f32, fused_mul_add

HOTNESS_PROVIDERS = ("exact", "sampled", "sketch", "neomem")


def cold_score(t: int, last_access: torch.Tensor,
               hot: torch.Tensor) -> torch.Tensor:
    """The ONE demotion/reclaim ranking score: LRU age in ticks, hotness as
    the tiebreak within an age class (higher = colder = demoted first)."""
    return (t - last_access).to(torch.float32) * 1e3 - hot


# ------------------------------------------------------------- the seam ----
class RowSpace(NamedTuple):
    """Tenant-local page addressing: row t lists tenant t's pages."""
    page: torch.Tensor    # [T, S] int32 page id, -1 = empty slot
    valid: torch.Tensor   # [T, S] bool


class HotCtx(NamedTuple):
    """Everything tick step 3 hands the active hotness provider."""
    hstate: Any                    # provider state (None = stateless)
    prev_hot: torch.Tensor         # [L] post-lifecycle hot from last tick
    accesses: torch.Tensor         # [L] f32 this tick
    alive: torch.Tensor            # [L] bool
    new: torch.Tensor              # [L] bool pages allocated this tick
    tier: torch.Tensor             # [L] int32, post-allocation
    last_access: torch.Tensor      # [L] int32, post-recency-update
    owner: torch.Tensor            # [L] int32
    owner_c: torch.Tensor          # [L] int32 gather-safe owner
    t: int                         # the tick
    rows: Callable[[], RowSpace]   # lazy tenant rowspace
    strategy: SEL.Strategy         # the ownership provider's selection ops
    prev_masked: bool = False      # prev_hot passed the lifecycle's
    #                                where(reclaimed, 0, hot) (see ewma)


class PromoCand(NamedTuple):
    """Promotion-candidate ops for tick step 6 (post-demotion tier view)."""
    cand_t: torch.Tensor                                 # [T] candidate count
    select: Callable[[torch.Tensor], SEL.Selection]      # quotas [T]
    select_global: Callable[[torch.Tensor], SEL.Selection]  # budget (tpp)


class HotnessView(NamedTuple):
    """One tick's hotness products, consumed by tick steps 3-6b."""
    hstate: Any                    # carried into the next TierState
    hot: torch.Tensor              # [L] dense hotness
    demand_t: torch.Tensor         # [T] promotion demand (step 4, pre-cap)
    promo_cand: Callable[[torch.Tensor, torch.Tensor], PromoCand]
    demote: Callable[[torch.Tensor, torch.Tensor], SEL.Selection]
    demote_global: Callable[[torch.Tensor, torch.Tensor], SEL.Selection]


class HotnessProvider(NamedTuple):
    name: str
    init: Callable[[torch.device], Any]   # the state (None = stateless)
    step: Callable[[HotCtx], HotnessView]


def ewma(cfg: TieringConfig, ctx: HotCtx,
         acc: torch.Tensor) -> torch.Tensor:
    """The dense EWMA ``where(alive, decay * prev_hot + acc, 0)`` with the
    reference's rounding. XLA contracts the multiply-add into one fused
    multiply-add (one rounding), except where ``prev_hot`` is the dynamic
    lifecycle's ``where(reclaimed, 0, hot)``: the compiler folds the
    multiply into that select, and the product rounds on its own before
    the add."""
    if ctx.prev_masked:
        val = f32(cfg.hot_decay) * ctx.prev_hot + acc
    else:
        val = fused_mul_add(cfg.hot_decay, ctx.prev_hot, acc)
    return torch.where(ctx.alive, val, 0.0)


def _dense_view(cfg: TieringConfig, k_max: int, ctx: HotCtx,
                hot: torch.Tensor, hstate: Any) -> HotnessView:
    """The exact engine's candidate/selection ops over a dense hot vector."""
    T = cfg.n_tenants
    thr = cfg.promo_hot_threshold
    strat = ctx.strategy
    cand_pre = (ctx.tier == TIER_SLOW) & (hot >= thr) & ctx.alive
    demand_t = strat.by_tenant(cand_pre.to(torch.int32), ctx.owner)
    cold = cold_score(ctx.t, ctx.last_access, hot)

    def demote(fast_mask, quotas):
        return strat.select(cold, ctx.owner, fast_mask, quotas)

    def demote_global(fast_mask, quota):
        return SEL.Selection(
            SEL.select_global(cold, fast_mask, quota, k_max * T),
            None, None, None)

    def promo_cand(tier, demoted):
        cand = (tier == TIER_SLOW) & (hot >= thr) & ctx.alive & ~demoted
        cand_t = strat.by_tenant(cand.to(torch.int32), ctx.owner)
        return PromoCand(
            cand_t,
            lambda quotas: strat.select(hot, ctx.owner, cand, quotas),
            lambda quota: SEL.Selection(
                SEL.select_global(hot, cand, quota, k_max * T),
                None, None, None))

    return HotnessView(hstate=hstate, hot=hot, demand_t=demand_t,
                       promo_cand=promo_cand, demote=demote,
                       demote_global=demote_global)


def exact_hotness(cfg: TieringConfig, n_pages: int,
                  k_max: int) -> HotnessProvider:
    """The dense EWMA ``where(alive, decay * prev + accesses, 0)``."""
    def step(ctx: HotCtx) -> HotnessView:
        return _dense_view(cfg, k_max, ctx, ewma(cfg, ctx, ctx.accesses),
                           None)

    return HotnessProvider("exact", lambda device: None, step)


# ------------------------------------------------------- provider specs ----
class SampledSpec(NamedTuple):
    frac: float = 0.25    # fraction of pages instrumented per tick
    seed: int = 0


class SketchSpec(NamedTuple):
    depth: int = 2        # count-min rows
    width: int = 1 << 15  # buckets per row (power of two)
    n_cand: int = 128     # per-tenant promotion-candidate buffer
    n_cold: int = 128     # per-tenant demotion-victim buffer
    probe: int = 4096     # sampled access lanes per tick (split across T)
    seed: int = 0


class NeomemSpec(NamedTuple):
    n_report: int = 256   # hot pages per tenant in each device report


class SketchState(NamedTuple):
    cms: torch.Tensor        # [depth, width] f32 decayed counts
    cand_page: torch.Tensor  # [T, n_cand] int32, est-descending, -1 empty
    cold_page: torch.Tensor  # [T, n_cold] int32, cold-descending, -1 empty


class NeomemState(NamedTuple):
    report_page: torch.Tensor   # [T, n_report] int32 last tick's report
    report_hot: torch.Tensor    # [T, n_report] f32 reported hotness


# ------------------------------------------------- compact row selection ----
def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def _row_select(pages: torch.Tensor, take: torch.Tensor,
                quotas: torch.Tensor, n_pages: int) -> SEL.Selection:
    """Quota select over score-ordered buffer rows ([T, N], best lane
    first): the per-tenant top-quota is an exclusive running count over the
    eligible lanes — no sort, O(T*N)."""
    ti = take.to(torch.int32)
    order = torch.cumsum(ti, dim=1, dtype=torch.int32) - ti
    sel = take & (order < quotas[:, None])
    mask = SEL._scatter_mask(torch.where(sel, pages, n_pages), n_pages)
    return SEL.Selection(mask=mask, pages=pages, take=sel,
                         counts=sel.sum(dim=1, dtype=torch.int32))


def _flat_select(score: torch.Tensor, pages: torch.Tensor,
                 take: torch.Tensor, quota, k_cap: int,
                 n_pages: int) -> SEL.Selection:
    """Tenant-blind top-quota over flattened buffer lanes (the tpp global
    scan, restricted to the provider's tracked candidates)."""
    s = torch.where(take, score, float("-inf")).reshape(-1)
    k = min(k_cap, s.shape[0])
    vals, idx = top_k(s, k)
    tk = (torch.arange(k, device=s.device) < quota) & (vals > float("-inf"))
    pg = pages.reshape(-1)[idx]
    return SEL.Selection(
        SEL._scatter_mask(torch.where(tk, pg, n_pages), n_pages),
        None, None, None)


# ------------------------------------------------------------- providers ----
def sampled_hotness(cfg: TieringConfig, n_pages: int, k_max: int,
                    spec: SampledSpec) -> HotnessProvider:
    """Dense EWMA fed by a rotating page subset with unbiased scaling.

    The subset is a multiplicative-hash residue class shifted by the tick
    (page*A + t*B mod 2^20 < frac*2^20, A and B odd): every page is
    instrumented ``frac`` of ticks, and the 1/frac scaling keeps E[hot]
    equal to the exact EWMA. Stateless."""
    M = 1 << 20
    thresh = int(np.int32(min(max(spec.frac, 0.0), 1.0) * M))
    A = 2 * ((spec.seed * 131) % 1024) + 1093   # odd, < 2**12
    B = 2 * ((spec.seed * 37) % 1024) + 40503   # odd, < 2**16
    inv = f32(np.float32(1.0 / max(spec.frac, 1e-9)))

    def step(ctx: HotCtx) -> HotnessView:
        page_mix = torch.arange(n_pages, dtype=torch.int32,
                                device=ctx.accesses.device) * A
        # int32 wrap of page*A + t*B never reaches the low 20 bits
        smask = ((page_mix + (ctx.t * B) % M) & (M - 1)) < thresh
        acc = torch.where(smask, ctx.accesses * inv, 0.0)
        return _dense_view(cfg, k_max, ctx, ewma(cfg, ctx, acc), None)

    return HotnessProvider("sampled", lambda device: None, step)


def sketch_hotness(cfg: TieringConfig, n_pages: int, k_max: int,
                   spec: SketchSpec) -> HotnessProvider:
    """Count-min hotness with per-tenant candidate/victim buffers.

    Per tick: probe ``probe`` tenant-rowspace lanes (every lane when a
    tenant's rowspace fits its share of the budget: full coverage), scatter
    their scaled accesses into the decayed sketch, then refresh two [T, N]
    buffers by merging last tick's entries with the fresh probes under one
    batched top-k per buffer — candidates ranked by estimate, victims by
    ``cold_score``. Steps 4-6b select from the buffers with running-count
    quota cuts.

    Probe lanes are presented in ascending page order (full enumeration is
    ``arange``; random probes are row-sorted), so the top-k's lower-lane
    tie-break inherits the exact engine's lower-page-wins rule."""
    T = cfg.n_tenants
    L = n_pages
    thr = cfg.promo_hot_threshold
    # hash int32 safety: (pages + width) * mult < 2**31 (core/cms.py)
    assert (L + spec.width) * CM.MULT_MAX < 2 ** 31, (L, spec.width)
    base_key = TF.prng_key(spec.seed)
    r = max(spec.probe // T, 1)
    params: dict = {}

    def params_on(device) -> CM.CMSParams:
        if device not in params:
            params[device] = CM.cms_params(spec.depth, spec.width,
                                           cfg.hot_decay, spec.seed, device)
        return params[device]

    def init(device) -> SketchState:
        return SketchState(
            cms=CM.make_cms(params_on(device)),
            cand_page=torch.full((T, spec.n_cand), -1, dtype=torch.int32,
                                 device=device),
            cold_page=torch.full((T, spec.n_cold), -1, dtype=torch.int32,
                                 device=device))

    def step(ctx: HotCtx) -> HotnessView:
        st: SketchState = ctx.hstate
        dev = st.cms.device
        p = params_on(dev)
        rows = ctx.rows()
        S = rows.page.shape[1]
        row_t = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
        alive, owner = ctx.alive, ctx.owner

        # ---- probe: sampled access lanes in tenant-local space ----------
        if r >= S:         # full coverage: the exact stream
            sp, in_row = rows.page, rows.valid
        else:              # with-replacement draws; E[hits] = r/S per page
            key = TF.fold_in(base_key, ctx.t)
            u = torch.sort(TF.randint(key, (T, r), 0, S, dev), dim=1).values
            dup_u = torch.cat([torch.zeros((T, 1), dtype=torch.bool,
                                           device=dev),
                               u[:, 1:] == u[:, :-1]], dim=1)
            sp = torch.gather(rows.page, 1, _i64(u))
            in_row = torch.gather(rows.valid, 1, _i64(u)) & ~dup_u
        spc = _i64(torch.clamp(sp, min=0))
        sv = in_row & alive[spc]
        if r >= S and L <= spec.width:
            # full coverage + injective hash: each page owns its buckets, so
            # the recurrence is the exact engine's where(alive, decay * prev
            # + accesses, 0), written per lane (scatter-set; dead lanes
            # write 0, the page-free reset) — estimates track the dense EWMA
            prev = CM.cms_estimate(p, st.cms, spc)
            val = torch.where(sv, fused_mul_add(p.decay, prev,
                                                ctx.accesses[spc]), 0.0)
            sk = CM.cms_assign(p, st.cms, spc, val, in_row)
        else:
            scale = f32(np.float32(S) / np.float32(r)) if r < S else 1.0
            amt = torch.where(sv, ctx.accesses[spc] * scale, 0.0)
            sk = CM.cms_add(p, CM.cms_decay(p, st.cms), spc, amt, sv)
            # probed dead pages reset their counters (the page-free hook);
            # an empty clear is a value no-op, so it runs every tick
            sk = CM.cms_clear(p, sk, spc, in_row & ~alive[spc])

        # ---- refresh the candidate/victim buffers -----------------------
        def merge(buf, n, score_of):
            if r >= S:
                # full coverage: the probes enumerate every page in order,
                # so the buffer is a pure function of the current sketch
                pool = torch.where(sv, sp, -1)
            else:
                # keep last tick's entries; a probe already in the buffer
                # keeps its buffer lane (rows never hold a page twice)
                resident = (sp[:, :, None] == buf[:, None, :]).any(dim=2)
                pool = torch.cat([buf, torch.where(sv & ~resident, sp, -1)],
                                 dim=1)
            pc = _i64(torch.clamp(pool, min=0))
            ok = (pool >= 0) & alive[pc] & (owner[pc] == row_t)
            est = CM.cms_estimate(p, sk, pc)
            return CM.topn_rows(score_of(pc, est), pool, ok, n)

        cand_page, cand_est = merge(st.cand_page, spec.n_cand,
                                    lambda pc, est: est)
        cold_page, cold_val = merge(
            st.cold_page, spec.n_cold,
            lambda pc, est: cold_score(ctx.t, ctx.last_access[pc], est))

        cp = torch.clamp(cand_page, min=0)
        cvalid = cand_page >= 0
        dp = torch.clamp(cold_page, min=0)
        dvalid = cold_page >= 0
        dest = CM.cms_estimate(p, sk, dp)
        cp64, dp64 = _i64(cp), _i64(dp)

        # dense hot carry/telemetry: tracked estimates, 0 elsewhere (a page
        # in both buffers carries the same estimate twice)
        idx = torch.cat([torch.where(cvalid, cp, L),
                         torch.where(dvalid, dp, L)], dim=1).reshape(-1)
        val = torch.cat([torch.where(cvalid, cand_est, 0.0),
                         torch.where(dvalid, dest, 0.0)], dim=1).reshape(-1)
        hot = torch.zeros((L + 1,), dtype=torch.float32, device=dev)
        hot[_i64(idx)] = val
        hot = hot[:L]

        live_c = cvalid & alive[cp64] & (cand_est >= thr)
        is_cand = live_c & (ctx.tier[cp64] == TIER_SLOW)
        demand_t = is_cand.sum(dim=1, dtype=torch.int32)

        def promo_cand(tier, demoted):
            take = live_c & (tier[cp64] == TIER_SLOW) & ~demoted[cp64]
            return PromoCand(
                take.sum(dim=1, dtype=torch.int32),
                lambda quotas: _row_select(cp, take, quotas, L),
                lambda quota: _flat_select(cand_est, cp, take, quota,
                                           k_max * T, L))

        def demote(fast_mask, quotas):
            take = dvalid & fast_mask[dp64] & alive[dp64]
            return _row_select(dp, take, quotas, L)

        def demote_global(fast_mask, quota):
            take = dvalid & fast_mask[dp64] & alive[dp64]
            return _flat_select(cold_val, dp, take, quota, k_max * T, L)

        return HotnessView(
            hstate=SketchState(cms=sk, cand_page=cand_page,
                               cold_page=cold_page),
            hot=hot, demand_t=demand_t, promo_cand=promo_cand,
            demote=demote, demote_global=demote_global)

    return HotnessProvider("sketch", init, step)


def neomem_hotness(cfg: TieringConfig, n_pages: int, k_max: int,
                   spec: NeomemSpec) -> HotnessProvider:
    """Emulated device-side hot-page tracker (NeoMem direction): the device
    counts every access and publishes a per-tenant top-N report each tick;
    the promotion pipeline consumes it one tick late, demotion keeps the
    dense LRU metadata."""
    T = cfg.n_tenants
    L = n_pages
    thr = cfg.promo_hot_threshold

    def init(device) -> NeomemState:
        return NeomemState(
            report_page=torch.full((T, spec.n_report), -1, dtype=torch.int32,
                                   device=device),
            report_hot=torch.zeros((T, spec.n_report), dtype=torch.float32,
                                   device=device))

    def step(ctx: HotCtx) -> HotnessView:
        st: NeomemState = ctx.hstate
        dev = st.report_page.device
        hot = ewma(cfg, ctx, ctx.accesses)
        view = _dense_view(cfg, k_max, ctx, hot, None)
        row_t = torch.arange(T, dtype=torch.int32, device=dev)[:, None]

        # promotion path: last tick's report (stale entries die on the
        # alive/owner checks)
        rp = torch.clamp(st.report_page, min=0)
        rp64 = _i64(rp)
        rvalid = ((st.report_page >= 0) & ctx.alive[rp64]
                  & (ctx.owner[rp64] == row_t))
        rhot = st.report_hot
        live = rvalid & (rhot >= thr)
        is_cand = live & (ctx.tier[rp64] == TIER_SLOW)
        demand_t = is_cand.sum(dim=1, dtype=torch.int32)

        def promo_cand(tier, demoted):
            take = live & (tier[rp64] == TIER_SLOW) & ~demoted[rp64]
            return PromoCand(
                take.sum(dim=1, dtype=torch.int32),
                lambda quotas: _row_select(rp, take, quotas, L),
                lambda quota: _flat_select(rhot, rp, take, quota,
                                           k_max * T, L))

        # this tick's device report, delivered next tick
        rows = ctx.rows()
        rpg = _i64(torch.clamp(rows.page, min=0))
        rok = rows.valid & ctx.alive[rpg]
        pages, vals = CM.topn_rows(hot[rpg], rows.page, rok, spec.n_report)
        hstate = NeomemState(report_page=pages,
                             report_hot=torch.where(pages >= 0, vals, 0.0))
        return view._replace(hstate=hstate, demand_t=demand_t,
                             promo_cand=promo_cand)

    return HotnessProvider("neomem", init, step)


# ------------------------------------------------------ resolution / init ----
def _norm(spec):
    if isinstance(spec, str):
        if spec not in HOTNESS_PROVIDERS:
            raise ValueError(f"unknown hotness provider {spec!r}; "
                             f"expected one of {HOTNESS_PROVIDERS}")
        return {"exact": None, "sampled": SampledSpec(),
                "sketch": SketchSpec(), "neomem": NeomemSpec()}[spec]
    return spec


def resolve_hotness(spec, cfg: TieringConfig, n_pages: int,
                    k_max: int) -> HotnessProvider:
    """Accepts None/"exact" (the dense EWMA), a provider name, a spec
    NamedTuple, or a prebuilt HotnessProvider."""
    spec = _norm(spec)
    if spec is None:
        return exact_hotness(cfg, n_pages, k_max)
    if isinstance(spec, HotnessProvider):
        return spec
    if isinstance(spec, SampledSpec):
        return sampled_hotness(cfg, n_pages, k_max, spec)
    if isinstance(spec, SketchSpec):
        return sketch_hotness(cfg, n_pages, k_max, spec)
    if isinstance(spec, NeomemSpec):
        return neomem_hotness(cfg, n_pages, k_max, spec)
    raise TypeError(f"not a hotness provider spec: {spec!r}")


def init_hotness(spec, cfg: TieringConfig, n_pages: int, device="cuda"):
    """The state for ``init_state(..., hotness=...)``: None for the
    stateless providers."""
    device = resolve_device(device)
    return resolve_hotness(spec, cfg, n_pages, k_max=256).init(device)


def static_rowspace(owner: np.ndarray, n_tenants: int,
                    device="cuda") -> RowSpace:
    """RowSpace for a constant owner vector (any permutation)."""
    device = resolve_device(device)
    page = torch.as_tensor(SEL.static_rows(owner, n_tenants), device=device)
    return RowSpace(page=page, valid=page >= 0)
