"""Decayed count-min sketch over hashed page ids (torch port of
``repro/core/cms.py``; the HybridTier direction).

Page hotness lives in a ``[depth, width]`` count-min sketch: every sampled
access adds its (scaled) weight to one bucket per row, the whole sketch
decays by ``hot_decay`` each tick, and an estimate is the min over rows
(never below the true decayed count).

Hash: ``((page + b_d) * a_d) & (width - 1)``, width a power of two, a_d odd
and below 2**10, so any window of fewer than ``width`` consecutive page ids
is collision-free within itself, and ``(page + b) * a`` stays inside int32
for pools up to about 2**20 pages (``sketch_hotness`` asserts it).

Scatters drop lanes whose bucket is the sentinel ``width`` (the reference's
``mode="drop"``) by writing into a scratch column. Adds go through
``index_put_(accumulate=True)``, which adds duplicates in lane order on the
CPU and, sorted stably by bucket, on a card: the same float32 sums on every
run.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.select.ref import top_k
from repro_torch.numerics import f32

MULT_MAX = 1 << 10        # exclusive bound on the hash multipliers


class CMSParams(NamedTuple):
    """Sketch geometry + hash constants (derived from ``seed``)."""
    depth: int
    width: int            # power of two
    decay: float          # per-tick multiplicative decay (1.0 = pure count)
    mults: torch.Tensor   # [depth] int32 odd, < MULT_MAX
    offs: torch.Tensor    # [depth] int32, < width


def cms_params(depth: int = 2, width: int = 1 << 15, decay: float = 1.0,
               seed: int = 0, device="cuda") -> CMSParams:
    assert width & (width - 1) == 0, f"width must be a power of two: {width}"
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    mults = (rng.integers(0, MULT_MAX // 2, depth) * 2 + 1).astype(np.int32)
    offs = rng.integers(0, width, depth).astype(np.int32)
    return CMSParams(depth=depth, width=width, decay=decay,
                     mults=torch.as_tensor(mults, device=device),
                     offs=torch.as_tensor(offs, device=device))


def make_cms(p: CMSParams) -> torch.Tensor:
    return torch.zeros((p.depth, p.width), dtype=torch.float32,
                       device=p.mults.device)


def cms_hash(p: CMSParams, pages: torch.Tensor) -> torch.Tensor:
    """[depth, *pages.shape] int32 bucket index per row. ``pages`` must be
    >= 0 and small enough that ``(page + width) * mult`` stays in int32."""
    shape = (p.depth,) + (1,) * pages.dim()
    a = p.mults.reshape(shape)
    b = p.offs.reshape(shape)
    return ((pages.to(torch.int32)[None] + b) * a) & (p.width - 1)


def _lanes(p: CMSParams, pages: torch.Tensor, valid: torch.Tensor):
    """(row, bucket) int64 index pair per lane and row; invalid lanes point
    at the scratch column ``width``."""
    h = torch.where(valid[None], cms_hash(p, pages), p.width)
    d = torch.arange(p.depth, device=h.device).reshape(
        (p.depth,) + (1,) * pages.dim()).expand(h.shape)
    return d.reshape(-1), h.reshape(-1).to(torch.int64)


def _padded(cms: torch.Tensor) -> torch.Tensor:
    return torch.cat([cms, cms.new_zeros((cms.shape[0], 1))], dim=1)


def cms_add(p: CMSParams, cms: torch.Tensor, pages: torch.Tensor,
            amounts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Add ``amounts`` into every row's bucket for each valid lane."""
    d, h = _lanes(p, pages, valid)
    vals = amounts.to(torch.float32)[None].expand(
        (p.depth,) + tuple(pages.shape)).reshape(-1)
    buf = _padded(cms)
    buf.index_put_((d, h), vals, accumulate=True)
    return buf[:, :p.width]


def cms_assign(p: CMSParams, cms: torch.Tensor, pages: torch.Tensor,
               values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Set each valid lane's value into every row's bucket. Sound only when
    the valid lanes cover disjoint buckets (distinct pages of an injective
    window); the full-coverage sketch relies on it."""
    d, h = _lanes(p, pages, valid)
    vals = values.to(torch.float32)[None].expand(
        (p.depth,) + tuple(pages.shape)).reshape(-1)
    buf = _padded(cms)
    buf.index_put_((d, h), vals)
    return buf[:, :p.width]


def cms_clear(p: CMSParams, cms: torch.Tensor, pages: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Zero every row's bucket for each valid lane (the page-free hook)."""
    d, h = _lanes(p, pages, valid)
    buf = _padded(cms)
    buf[d, h] = 0.0
    return buf[:, :p.width]


def cms_decay(p: CMSParams, cms: torch.Tensor) -> torch.Tensor:
    """One tick of exponential aging."""
    return cms * f32(p.decay)


def cms_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two sketches built with the same params (elementwise add)."""
    return a + b


def cms_estimate(p: CMSParams, cms: torch.Tensor,
                 pages: torch.Tensor) -> torch.Tensor:
    """Point estimate per lane: min over the depth rows."""
    h = cms_hash(p, pages).to(torch.int64)
    d = torch.arange(p.depth, device=h.device).reshape(
        (p.depth,) + (1,) * pages.dim())
    return cms[d, h].amin(dim=0)


def topn_rows(score: torch.Tensor, page: torch.Tensor, valid: torch.Tensor,
              n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-n lanes of each row by score, best first.

    score/page/valid: [T, M]. Returns ``(pages [T, n] int32, score [T, n])``
    with -1 page ids (and -inf scores) on empty lanes, padded with empties
    when M < n. Ties keep the lower lane (``lax.top_k``), through the port's
    stable ``top_k``."""
    T, M = score.shape
    s = torch.where(valid, score, float("-inf"))
    k = min(n, M)
    vals, cols = top_k(s, k)
    keep = vals > float("-inf")
    pages = torch.where(keep, torch.gather(page, 1, cols), -1
                        ).to(torch.int32)
    if k < n:
        pages = torch.cat([pages, pages.new_full((T, n - k), -1)], dim=1)
        vals = torch.cat([vals, vals.new_full((T, n - k), float("-inf"))],
                         dim=1)
    return pages, vals
