"""Plain torch version of the Mamba2 decode-state kernel: the decode
step's expression from the conv outputs to y, as ``models/ssm.py`` wrote
it before the kernel (groups broadcast to heads, ``state_update``'s
float64 multiply-add, the read-out einsum, the ``D`` skip)."""
from __future__ import annotations

import torch

from repro_torch.models.ssm import state_update


def ssd_decode_ref(h, x, b, c, dt, da, D):
    """h [B,H,P,N] float32; x [B,H,P]; b, c [B,G,N] with G dividing H (head
    h reads group h // (H/G)); dt, da [B,H]; D [H]. Returns (the new state,
    a new tensor, y [B,H,P] float32)."""
    f32 = torch.float32
    rep = x.shape[1] // b.shape[1]
    xh = x.to(f32)
    bh = torch.repeat_interleave(b, rep, dim=1).to(f32)
    ch = torch.repeat_interleave(c, rep, dim=1).to(f32)
    h = state_update(h, da, xh, bh, dt)
    y = torch.einsum("bhn,bhpn->bhp", ch, h)
    return h, y + D.to(f32)[None, :, None] * xh
