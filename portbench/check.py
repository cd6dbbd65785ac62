"""What decides ``correct``: the numbers compared with the plain reference,
and the tiering guarantees read off the program's state. Each number is
held to the limit the cell's file gives it (``limits``); a run is correct
when every number is at or under its limit."""
from __future__ import annotations

import numpy as np
import torch


def served_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position. ref_logits [..., V] float32,
    tokens [...]."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens.long()[..., None])[..., 0]
    return float((best - got).max())


def logit_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def tiering_violations(snap: dict, budget: int, bounds, page_tokens: int
                       ) -> dict:
    """The guarantees the tiering makes hard, read off one state of the
    program's tiered KV cache (host copies of its page tables):

    - every page a sequence has written lies in exactly one tier: its page
      table entry names a tier and a slot, that slot holds the page, and no
      other slot of either tier does;
    - the fast pages of all sequences together stay within the global fast
      budget (allocation ranks the batch's new pages against it, and a
      promotion needs headroom under it);
    - a tenant with an upper bound b > 0 holds at most b + n - 1 fast pages,
      n its sequences: a new page goes to the fast tier only while the
      tenant is under b at the start of the step, every sequence of the
      tenant may place one such page in that step, and promotions stop at
      b. (The bound is not hard at every step: the pages placed past it are
      demoted back, at most four a step.)

    Returns the count of each kind of violation."""
    fast, slow = snap["fast_page"], snap["slow_page"]
    tier, idx = snap["page_tier"].astype(np.int64), snap["page_idx"]
    seq_len, tenant = snap["seq_len"], snap["tenant"]
    B, M = tier.shape
    rows = np.arange(B)[:, None]
    pages = np.arange(M)[None, :]
    written = pages < ((seq_len[:, None] + page_tokens - 1) // page_tokens)
    in_fast = (tier == 0) & (fast[rows, np.clip(idx, 0, fast.shape[1] - 1)]
                             == pages)
    in_slow = (tier == 1) & (slow[rows, np.clip(idx, 0, slow.shape[1] - 1)]
                             == pages)
    copies = ((fast[:, :, None] == pages[:, None, :]).sum(1)
              + (slow[:, :, None] == pages[:, None, :]).sum(1))
    misplaced = written & ~((in_fast | in_slow) & (copies == 1))
    used = fast >= 0
    n_fast = int(used.sum())
    per_tenant = np.bincount(tenant, weights=used.sum(1),
                             minlength=len(bounds))
    n_seq = np.bincount(tenant, minlength=len(bounds))
    over = [max(0, int(per_tenant[t]) - (b + int(n_seq[t]) - 1))
            for t, b in enumerate(bounds) if b > 0]
    return {"pages_not_in_one_tier": int(misplaced.sum()),
            "fast_pages_over_budget": max(0, n_fast - budget),
            "fast_pages_over_bounds": int(sum(over))}
