"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule,
and optional int8 block-quantized gradient compression (torch port of the
reference's ``optim/adamw.py``; the compression simulates a compressed
data-parallel all-reduce payload).

The optimizer state is ``OptState(m, v, step)``: ``m`` and ``v`` are
float32 dicts keyed by parameter name (the dotted path of the reference's
tree), ``step`` an int32 scalar tensor. Every tree of the module is a flat
dict in the reference's leaf order (``tree_order``: sorted path parts, as
``tree_leaves`` orders a nested dict), and sums over leaves (the global
norm) follow that order. ``adamw_update`` writes the new parameters into
the given tensors in place, under ``no_grad`` (the reference returns new
ones); it returns them with the new state.

Under ``jit`` XLA rewrites a division by a constant into a product with the
constant's float32 reciprocal; ``_div_const`` does the same, so the
schedule and the int8 scales round as the jitted reference's do.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import TrainConfig

f32 = torch.float32


def _div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant c as XLA computes it: x times the float32
    reciprocal of c."""
    return x * float(np.float32(1) / np.float32(c))


class OptState(NamedTuple):
    m: Dict[str, torch.Tensor]      # like params, float32
    v: Dict[str, torch.Tensor]      # like params, float32
    step: torch.Tensor              # int32 scalar


def tree_order(names):
    """Names in the reference's leaf order: path parts sorted level by
    level."""
    return sorted(names, key=lambda n: n.split("."))


def flat_params(params) -> Dict[str, torch.Tensor]:
    """A model's parameters (or a nested or flat dict of tensors) as a flat
    dict keyed by dotted name, in ``tree_order``."""
    if isinstance(params, nn.Module):
        flat = dict(params.named_parameters())
    else:
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    flat[f"{prefix}{k}"] = v
        walk(params, "")
    return {k: flat[k] for k in tree_order(flat)}


def init_opt_state(params) -> OptState:
    flat = flat_params(params)
    m = {k: torch.zeros(p.shape, dtype=f32, device=p.device)
         for k, p in flat.items()}
    dev = next(iter(flat.values())).device
    return OptState(m=m, v={k: t.clone() for k, t in m.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def abstract_opt_state(abstract_params) -> OptState:
    """The state of ``abstract_params`` (meta tensors) as meta tensors."""
    m = {k: torch.empty(p.shape, dtype=f32, device="meta")
         for k, p in flat_params(abstract_params).items()}
    return OptState(m=m, v=dict(m), step=torch.empty(
        (), dtype=torch.int32, device="meta"))


def lr_schedule(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    s = step.to(f32)
    warm = torch.clamp(_div_const(s, max(tc.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(_div_const(s - tc.warmup_steps,
                                  max(tc.total_steps - tc.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    leaves = [tree[k] for k in tree_order(tree)]
    return torch.sqrt(sum(torch.sum(torch.square(l.to(f32)))
                          for l in leaves))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g.to(f32) * scale for k, g in grads.items()}, norm


def compress_grads_int8(grads: Dict[str, torch.Tensor], block: int = 256
                        ) -> Dict[str, torch.Tensor]:
    """Simulated compressed DP all-reduce: block-wise int8
    quantize-dequantize (``torch.round`` rounds half to even, as
    ``jnp.round`` does), so training sees the compressed collective's
    numerics."""
    def q(g):
        flat = g.to(f32).reshape(-1)
        n = flat.shape[0]
        flat = F.pad(flat, (0, (-n) % block)).reshape(-1, block)
        scale = _div_const(flat.abs().amax(dim=1, keepdim=True), 127.0)
        qv = torch.clamp(torch.round(flat / torch.clamp(scale, min=1e-12)),
                         -127, 127)
        return (qv * scale).reshape(-1)[:n].reshape(g.shape)
    return {k: q(g) for k, g in grads.items()}


@torch.no_grad()
def adamw_update(params, grads: Dict[str, torch.Tensor], opt: OptState,
                 tc: TrainConfig):
    """One AdamW step. ``params`` is a model or a dict of its parameter
    tensors by name; each is overwritten in place. Returns (the parameters
    by name, the new state, {"grad_norm", "lr"})."""
    params = flat_params(params)
    if tc.grad_compression:
        grads = compress_grads_int8(grads)
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    step = opt.step + 1
    lr = lr_schedule(step, tc)
    b1, b2 = tc.beta1, tc.beta2
    t = step.to(f32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32, device=t.device), t)
    new_m, new_v = {}, {}
    for k, p in params.items():
        g = grads[k]
        m = b1 * opt.m[k] + (1 - b1) * g
        v = b2 * opt.v[k] + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        p32 = p.to(f32)
        p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + tc.eps)
                          + tc.weight_decay * p32)
        p.copy_(p32.to(p.dtype))
        new_m[k], new_v[k] = m, v
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(m=new_m, v=new_v, step=step), metrics
