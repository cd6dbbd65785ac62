"""Training step (loss, grads with microbatch accumulation, AdamW update)
and the inference prefill: the torch port of the reference's
``train/step.py``.

Every self-, encoder and cross-attention of the forward runs K7 and every
Mamba2 block K8 with ``impl="cuda"`` (the default on a card), or their
plain versions with ``impl="ref"`` (the default on the CPU). Their
backward is the plain version's gradient (``kernels/*/ops.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import dtype_of
from repro_torch.models.transformer import (cast_params, model_forward,
                                            model_specs)
from repro_torch.obs.spans import span
from repro_torch.optim.adamw import OptState, adamw_update, flat_params

IMPLS = ("cuda", "ref")


def _resolve_impl(impl: Optional[str], device) -> str:
    dev = resolve_device(device)
    if impl is None:
        impl = "cuda" if dev.type == "cuda" else "ref"
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError("impl='cuda' needs a CUDA device; use impl='ref' on "
                         "the CPU")
    return impl


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token cross-entropy; stable in f32 over (possibly padded)
    vocab."""
    l32 = logits.to(torch.float32)
    lse = torch.logsumexp(l32, dim=-1)
    ll = torch.gather(l32, -1, labels.to(torch.int64)[..., None])[..., 0]
    return (lse - ll).mean()


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig, *, impl: str = "cuda"):
    """Returns loss_fn(model, batch) -> (ce + 0.01 aux, {"ce", "moe_aux"}).
    The float32 masters are cast to the compute dtype up front
    (``cast_params``), as the reference casts them; the gradients flow back
    to the masters."""
    compute_dt = dtype_of(cfg.dtype)

    def loss_fn(model, batch: Dict[str, torch.Tensor]):
        logits, aux = model_forward(cast_params(model, compute_dt), batch,
                                    impl=impl, return_aux=True,
                                    remat=tc.remat_policy)
        loss = cross_entropy(logits, batch["labels"])
        total = loss + 0.01 * aux
        return total, {"ce": loss, "moe_aux": aux}

    return loss_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                    impl: Optional[str] = None, device="cuda"):
    """Returns train_step(model, opt, batch) -> (opt, metrics).

    The step makes the model's parameters trainable, computes the loss and
    its gradients (left in each parameter's ``.grad``), and updates the
    parameters in place (``adamw_update``). With ``tc.microbatches`` n > 1
    the batch splits into n along its first axis, a Python loop
    accumulates float32 gradients and divides by n, and the metrics carry
    no ``ce``/``moe_aux``, as the reference's scan does. metrics:
    {"loss", "grad_norm", "lr"} (+ {"ce", "moe_aux"}), detached scalars.
    Spans: ``train.forward`` (each loss), ``train.backward`` (each
    ``backward()``, rematerialised forwards included) and
    ``train.optimizer``."""
    model_specs(cfg)                      # raises for an unknown family
    impl = _resolve_impl(impl, device)
    loss_fn = make_loss_fn(cfg, tc, impl=impl)

    def grads_of(params, model, batch):
        for p in params.values():
            p.grad = None
        with span("train.forward"):
            loss, extras = loss_fn(model, batch)
        with span("train.backward"):
            loss.backward()
        return loss.detach(), {k: v.detach() for k, v in extras.items()}

    def train_step(model, opt: OptState, batch: Dict[str, torch.Tensor]):
        model.requires_grad_(True)
        params = flat_params(model)
        n = tc.microbatches
        if n > 1:
            acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for k, p in params.items()}
            loss = 0.0
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                li, _ = grads_of(params, model, mb)
                for k, p in params.items():
                    acc[k] += p.grad.to(torch.float32)
                loss = loss + li
            grads = {k: g / n for k, g in acc.items()}
            for k, p in params.items():
                p.grad = grads[k].to(p.dtype)
            loss = loss / n
            extras = {}
        else:
            loss, extras = grads_of(params, model, batch)
            grads = {k: p.grad for k, p in params.items()}
        with span("train.optimizer"):
            _, opt, metrics = adamw_update(params, grads, opt, tc)
        return opt, {"loss": loss, **metrics, **extras}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, impl: Optional[str] = None,
                      device="cuda"):
    """Returns prefill_step(model, batch) -> the last position's logits
    [B,V]. ``batch`` is {"tokens": [B,S]}, plus ``frames`` [B, T_enc, d]
    for the encdec or ``image_embeds`` [B, n_img, d] for the vlm, passed
    through to the full forward (``model_forward``), whose self- and
    cross-attention (and the encoder's) run K7 and whose Mamba2 blocks run
    K8 with ``impl="cuda"`` (the default on a card), or their plain
    versions with ``impl="ref"`` (the default on the CPU); the MoE products
    are plain torch in both. Only the last position goes through the
    logits matmul (the reference computes all positions and keeps the
    last; the rows are independent). It runs under ``torch.no_grad``, in
    the span ``prefill.step``."""
    model_specs(cfg)                      # raises for an unknown family
    impl = _resolve_impl(impl, device)

    def prefill_step(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad(), span("prefill.step"):
            return model_forward(model, batch, impl=impl, last_only=True
                                 )[:, 0]

    return prefill_step
