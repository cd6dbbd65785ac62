"""Plain AdamW: decoupled weight decay, clipping by the global gradient norm,
linear warm-up into a cosine schedule that ends at a tenth of the peak rate,
bias-corrected moments, all in float32 on dicts of tensors keyed by name."""
from __future__ import annotations

import math
from typing import Dict

import torch


def learning_rate(step: int, lr: float, warmup: int, total: int) -> float:
    """The rate of optimizer step ``step`` (counted from 1)."""
    warm = min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return lr * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


@torch.no_grad()
def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], t: int, *,
         lr: float, warmup: int, total: int, beta1: float, beta2: float,
         eps: float, weight_decay: float, clip: float) -> float:
    """Step ``t`` (from 1): updates ``params``, ``m`` and ``v`` in place;
    returns the global norm of ``grads`` before clipping."""
    norm = math.sqrt(sum(float(g.double().pow(2).sum())
                         for g in grads.values()))
    scale = min(clip / max(norm, 1e-9), 1.0)
    rate = learning_rate(t, lr, warmup, total)
    for k, p in params.items():
        g = grads[k].float() * scale
        m[k].mul_(beta1).add_(g, alpha=1 - beta1)
        v[k].mul_(beta2).add_(g * g, alpha=1 - beta2)
        mhat = m[k] / (1 - beta1 ** t)
        vhat = v[k] / (1 - beta2 ** t)
        p32 = p.float()
        p.copy_(p32 - rate * (mhat / (vhat.sqrt() + eps)
                              + weight_decay * p32))
    return norm
