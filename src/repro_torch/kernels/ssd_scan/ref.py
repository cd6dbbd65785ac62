"""Plain torch version of the Mamba2 SSD scan kernel: the chunked SSD of
``models/ssm.py`` (as the reference's ``kernels/ssd_scan/ref.py`` uses
its framework's), with B and C given per group and broadcast to heads."""
from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_chunked


def ssd_scan_ref(x, a, b, c, chunk: int):
    """x: [B,S,H,P]; a: [B,S,H]; b, c: [B,S,G,N] with G dividing H (head h
    reads group h // (H/G)). Returns (y [B,S,H,P] in x's dtype,
    h [B,H,P,N] float32)."""
    rep = x.shape[2] // b.shape[2]
    bh = torch.repeat_interleave(b, rep, dim=2)
    ch = torch.repeat_interleave(c, rep, dim=2)
    return ssd_chunked(x, a, bh, ch, chunk)
