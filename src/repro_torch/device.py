"""Device resolution shared by every public constructor and entry point of
the port: the card is the default, and there is no silent CPU fallback;
and the copy of a result back to the host."""
from __future__ import annotations

import numpy as np
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


def to_host(x) -> np.ndarray:
    """A tensor's values as a numpy array on the host; arrays and array-like
    values pass through ``np.asarray``."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
