"""Inference prefill (port of the reference's ``train/step.py``
``make_prefill_step``).

The training step (loss, grads, AdamW) waits for the training slice of the
port, which needs backward passes of the K7 and K8 kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import model_forward, model_specs

IMPLS = ("cuda", "ref")


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
    last; the rows are independent)."""
    model_specs(cfg)                      # raises for an unknown family
    dev = resolve_device(device)
    if impl is None:
        impl = "cuda" if dev.type == "cuda" else "ref"
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError("impl='cuda' needs a CUDA device; use impl='ref' on "
                         "the CPU")

    def prefill_step(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            return model_forward(model, batch, impl=impl, last_only=True
                                 )[:, 0]

    return prefill_step
