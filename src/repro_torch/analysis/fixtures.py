"""Known-bad torch programs the analyzer must flag (and a clean one it must
not) — torch port of ``repro/analysis/fixtures.py``.

These are the analyzer's own regression surface: each fixture plants
exactly the defect one pass exists to catch, so
``tests/test_torch_analysis.py`` (and ``python -m repro_torch.analysis
--fixture <name> --gate``) can assert the pass fires — and that the clean
tick stays silent. Each returns an ``AuditTarget`` (or a build / source
for constancy and lint) on ``device``; bad fixtures are never baselined.
The clean fixture is the real (small) tick, so it is held to the real
tick's baseline entries (its deliberate float64 sites), and to nothing
more.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.interval import Interval
from repro_torch.analysis.targets import AuditTarget, static_tick_target

FIXTURES = ("purity", "dtype", "overflow", "constancy", "donation", "lint",
            "clean")


# --------------------------------------------------------------- purity ----
def bad_purity(device="cpu") -> AuditTarget:
    """A tick-shaped call that reads a device value on the host."""
    def tick(c, x):
        n = int(x.sum().item())          # the defect: a host round trip
        return c + n, c
    z = torch.zeros((), dtype=torch.int32, device=device)
    return AuditTarget("fixture:purity", tick, [(z, z + 1)],
                       names=("counter", "x"))


# ---------------------------------------------------------------- dtype ----
def bad_dtype(device="cpu") -> AuditTarget:
    """A float64 leak, and an int32 carry that leaves as int64 after an
    unguarded ``cumsum`` (torch widens int32 sums to int64 unless given a
    dtype)."""
    def tick(counter, hits):
        wide = (hits.to(torch.float64) * 2.0).sum()     # the float64 leak
        counter = counter + torch.cumsum(hits, dim=1)[:, -1]  # -> int64
        return counter, wide
    T, L = 3, 8
    counter = torch.zeros((T,), dtype=torch.int32, device=device)
    hits = torch.ones((T, L), dtype=torch.int32, device=device)
    return AuditTarget("fixture:dtype", tick, [(counter, hits)],
                       names=("counter", "hits"))


# ------------------------------------------------------------- overflow ----
def bad_overflow_carry(device="cpu") -> AuditTarget:
    """A per-tick counter growing ~L per tick: wraps int32 well inside the
    fleet horizon."""
    L = 262_144

    def tick(counter, hits):
        return counter + hits.sum(dtype=torch.int32), counter

    return AuditTarget(
        "fixture:overflow:carry", tick,
        [(torch.zeros((), dtype=torch.int32, device=device),
          torch.zeros((L,), dtype=torch.int32, device=device))],
        names=("counter", "hits"),
        input_ivals={"hits": Interval(0, 1, True)}, horizon=10_000)


def bad_overflow_f32(device="cpu") -> AuditTarget:
    """The old fleet accumulator shape: integer migration counts summed
    and cast to float32 — exact only to 2^24."""
    def tick(acc, counts):
        return acc + counts.sum(dtype=torch.int32).to(torch.float32), acc

    return AuditTarget(
        "fixture:overflow:f32", tick,
        [(torch.zeros((), dtype=torch.float32, device=device),
          torch.zeros((4096,), dtype=torch.int32, device=device))],
        names=("acc", "counts"),
        input_ivals={"counts": Interval(0, 32_768, True)}, horizon=1)


# ------------------------------------------------------------ constancy ----
def bad_constancy_build(T: int, device="cpu"):
    """A tenant-unrolled reduction: the op trace grows linearly in T."""
    def f(x):
        parts = []
        for t in range(T):                   # the defect: Python loop over T
            parts.append(x[t] * (t + 1))
        return sum(parts)
    return f, (torch.zeros((T, 8), dtype=torch.float32, device=device),)


def good_constancy_build(T: int, device="cpu"):
    """The batched twin: constant structure at any T."""
    def f(x):
        w = torch.arange(1, x.shape[0] + 1, dtype=torch.float32,
                         device=x.device)
        return (x * w[:, None]).sum(dim=0)
    return f, (torch.zeros((T, 8), dtype=torch.float32, device=device),)


# ------------------------------------------------------------- donation ----
def bad_donation(device="cpu"):
    """A "donated" update done out of place: a new buffer every call.
    Returns (fn, args, donate_argnums)."""
    def f(a, b):
        return a + b
    a = torch.zeros((8,), dtype=torch.float32, device=device)
    return f, (a, torch.ones_like(a)), (0,)


def good_donation(device="cpu"):
    """The in-place twin: the donated buffer is the output."""
    def f(a, b):
        return a.add_(b)
    a = torch.zeros((8,), dtype=torch.float32, device=device)
    return f, (a, torch.ones_like(a)), (0,)


# ----------------------------------------------------------------- lint ----
BAD_LINT_TENANT_LOOP = '''\
def make_tick(cfg):
    T = cfg.n_tenants
    def tick(state, inputs):
        acc = 0
        for ti in range(T):
            acc = acc + state[ti]
        return acc
    return tick
'''

BAD_LINT_NP_IN_GRAPH = '''\
import numpy as np
def make_tick(cfg):
    def tick(state, inputs):
        n = int(inputs.sum().item())
        return np.maximum(state, 0) + n
    return tick
'''

BAD_LINT_SEAM_DEFAULT = '''\
def make_tick(cfg, detector=False, attrib=0):
    def tick(state, inputs):
        return state
    return tick
'''

CLEAN_LINT = '''\
import torch
def make_tick(cfg, detector=None, attrib=None):
    def tick(state, inputs):
        return torch.clamp(state, min=0) + inputs
    return tick
'''


# ---------------------------------------------------------------- clean ----
def clean_tick(device="cpu") -> AuditTarget:
    """A real (small) unified tick at a modest horizon."""
    return static_tick_target("equilibria", T=2, pages_per=8, k_max=4,
                              horizon=100, device=device,
                              name="fixture:clean")
