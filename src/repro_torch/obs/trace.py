"""Fixed-capacity migration event ring buffer (torch port of
``repro/obs/trace.py``).

Every promotion/demotion executed by the tick appends a (tick, tenant, page,
direction, hotness-at-move) record, packed into ONE [capacity, 5] int32
tensor (hotness bit-cast with ``.view(torch.int32)``). The newest
``capacity`` events survive; ``decode_ring`` converts the ring to
structured numpy records host-side.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

DIR_PROMOTE = 0
DIR_DEMOTE = 1

# packed column order in MigrationRing.data
COL_TICK, COL_TENANT, COL_PAGE, COL_DIR, COL_HOT = range(5)

EVENT_DTYPE = np.dtype([("tick", np.int32), ("tenant", np.int32),
                        ("page", np.int32), ("direction", np.int32),
                        ("hotness", np.float32)])


class MigrationRing(NamedTuple):
    data: torch.Tensor    # [C, 5] int32: tick, tenant, page, direction,
    #                       hotness (f32 bit-cast); tick = -1 = never written
    head: torch.Tensor    # 0-d int32: total events ever recorded


def init_ring(capacity: int, device="cuda") -> MigrationRing:
    device = resolve_device(device)
    data = torch.zeros((capacity, 5), dtype=torch.int32, device=device)
    data[:, COL_TICK] = -1
    return MigrationRing(data=data,
                         head=torch.zeros((), dtype=torch.int32, device=device))


def ring_record(ring: MigrationRing, mask: torch.Tensor, pages: torch.Tensor,
                tenants: torch.Tensor, hotness: torch.Tensor, direction: int,
                t: int) -> MigrationRing:
    """Append all events where ``mask`` is set. mask/pages/tenants/hotness
    share one shape (any rank); events land oldest-first at head..head+n."""
    C = ring.data.shape[0]
    m = mask.reshape(-1)
    offs = torch.cumsum(m.to(torch.int32), 0, dtype=torch.int32) - 1
    total = offs[-1] + 1
    # if one call selects more than C events, keep only the newest C — the
    # window of C consecutive offsets keeps slot indices unique
    keep = m & (offs >= total - C)
    idx = torch.where(keep, (ring.head + offs) % C, C)   # C = dump row
    n = m.shape[0]
    rows = torch.stack([
        torch.full((n,), t, dtype=torch.int32, device=m.device),
        tenants.reshape(-1).to(torch.int32),
        pages.reshape(-1).to(torch.int32),
        torch.full((n,), direction, dtype=torch.int32, device=m.device),
        hotness.reshape(-1).to(torch.float32).contiguous().view(torch.int32),
    ], dim=-1)
    buf = torch.cat([ring.data, ring.data.new_zeros((1, 5))])
    buf.index_copy_(0, idx.long(), rows)
    return MigrationRing(data=buf[:C],
                         head=ring.head + m.sum(dtype=torch.int32))


def decode_ring(ring: MigrationRing) -> tuple[np.ndarray, int]:
    """Host-side decode: (events, n_dropped). ``events`` is a structured
    numpy array (EVENT_DTYPE) ordered oldest -> newest; ``n_dropped`` is how
    many older events were overwritten by wraparound."""
    data = ring.data.cpu().numpy()
    C = data.shape[0]
    head = int(ring.head)
    n = min(head, C)
    out = np.empty(n, EVENT_DTYPE)
    if n == 0:
        return out, 0
    # oldest surviving event sits at head % C when the ring has wrapped
    start = head % C if head > C else 0
    order = (start + np.arange(n)) % C
    out["tick"] = data[order, COL_TICK]
    out["tenant"] = data[order, COL_TENANT]
    out["page"] = data[order, COL_PAGE]
    out["direction"] = data[order, COL_DIR]
    out["hotness"] = data[order, COL_HOT].view(np.float32)
    return out, max(head - C, 0)


def ring_summary(ring: MigrationRing) -> dict:
    """Wraparound accounting for a ring (scalar head) or a batched ring
    (head [...]): how many events were ever recorded, how many the fixed
    capacity retains, and how many wrap dropped."""
    C = ring.data.shape[-2]
    head = ring.head.cpu().numpy().astype(np.int64)
    return {
        "capacity": C,
        "recorded": head if head.ndim else int(head),
        "retained": np.minimum(head, C) if head.ndim else int(min(int(head), C)),
        "dropped": np.maximum(head - C, 0) if head.ndim else int(max(int(head) - C, 0)),
    }
