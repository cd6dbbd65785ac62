"""Wrapper of the pool-partial attention kernel, and the two-tier decode
attention built on it.

``pool_attention_partial`` sends a CUDA tensor to the hand-written kernel
and a CPU tensor to the plain version; launches are counted in
``pool_attention_partial.launches``. ``tiered_attention`` runs one partial
per tier and merges them in torch (``merge_partials_ref``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.tiered_attention import kernel as K
from repro_torch.kernels.tiered_attention import ref as R


def pool_attention_partial(q, pool_k, pool_v, slot_page, seq_len, *,
                           window: Optional[int] = None,
                           sm_scale: Optional[float] = None):
    """Single-query attention partial over one tier's paged pool.
    q [B,H,D]; pool_k/v [B,Mp,pt,K,D]; slot_page [B,Mp]; seq_len [B].
    Returns (acc [B,H,D], m [B,H], l [B,H], mass [B,H,Mp]), f32."""
    slot_page = slot_page.to(torch.int32).contiguous()
    seq_len = seq_len.to(torch.int32).contiguous()
    if q.is_cuda:
        pool_attention_partial.launches += 1
        return K.pool_attention_partial_cuda(
            q.to(torch.float32).contiguous(), pool_k.contiguous(),
            pool_v.contiguous(), slot_page, seq_len, window=window,
            sm_scale=sm_scale)
    return R.pool_attention_partial_ref(q, pool_k, pool_v, slot_page,
                                        seq_len, window=window,
                                        sm_scale=sm_scale)


pool_attention_partial.launches = 0

IMPLS = ("cuda", "ref")


def tiered_attention(q, fast_k, fast_v, slow_k, slow_v, fast_page, slow_page,
                     seq_len, *, window: Optional[int] = None,
                     impl: str = "cuda"):
    """q: [B,1,H,D]; pools: [B,Mp,pt,K,D]; *_page: [B,Mp] absolute page ids
    (-1 free); seq_len: [B]. Returns (out [B,1,H,D], fast_mass [B,Mf],
    slow_mass [B,Ms]). impl "cuda" goes through the kernel wrapper, "ref"
    straight to the plain version (on any device)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    partial = (pool_attention_partial if impl == "cuda"
               else R.pool_attention_partial_ref)
    q2 = q[:, 0]
    pf = partial(q2, fast_k, fast_v, fast_page, seq_len, window=window)
    ps = partial(q2, slow_k, slow_v, slow_page, seq_len, window=window)
    out, (mf, ms) = R.merge_partials_ref(q.dtype, [pf, ps])
    return out[:, None], mf, ms
