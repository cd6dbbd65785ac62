"""Device resolution shared by every public constructor and entry point of
the port: the card is the default, and there is no silent CPU fallback."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. CUDA (the default everywhere in the
    port) raises when no card is present; the CPU runs only when asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the port on the CPU")
    return dev
