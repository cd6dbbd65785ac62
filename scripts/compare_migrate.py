#!/usr/bin/env python3
"""Time the page-move kernel (K6, ``migrate_pages``) of this checkout
against other builds of ``csrc/serving.cu``, in one process on one card.

    git archive <rev> src/repro_torch/kernels/csrc/serving.cu | tar -x -C old/
    python3 scripts/compare_migrate.py \\
        --old-source old=old/src/repro_torch/kernels/csrc/serving.cu \\
        --source other=path/to/serving.cu

``new`` is this checkout's library; ``--source NAME=PATH`` (repeatable)
builds another revision whose ``migrate_pages_launch`` takes one or two
pool pairs with int64 indices and a bool ``sel``, as this one's does;
``--old-source NAME=PATH`` builds a revision whose launcher takes a
single pool pair and int32 indices and ``sel`` (before K and V moved in
one launch), and its K+V case is two launches. Each build gets its
indices in its own dtypes, made before the timing. Every build uses the
flags of ``kernels/build.py`` (``build_variant``). Cases, in bf16: S1's
pools (Llama 3.2 1B: 16 layers, 64 sequences, 32 fast and 16 slow slots
of 16 tokens x 8 kv heads x 64, a 16 KiB page) with 16 sequences
selected, one pool (``chip_smoke.py`` phase 11's call) and K+V, and K+V
with none selected (a settled step); S3's (Zamba2-7B: 14 KV layers, 32
sequences, 16 and 16 slots of 16 tokens x 32 x 112, a 112 KiB page) with
16 selected, one pool and K+V. Each build is first held bitwise against
the plain version; then every case is timed in turns (the builds in
order, then in reverse; each turn the median of CUDA-event times over 50
back-to-back launches, ``chip_smoke.device_ms``). A case's line gives its
bytes (each selected page read once and written once), the bound at
3.35 TB/s and at the measured copy bandwidth (``chip_smoke.
copy_bandwidth``), then each build's median and its turns. Prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

HBM_BYTES_PER_S = 3.35e12
# name -> (L, B, M fast, M slow, pt, K, D, selected)
WIDTHS = {"S1": (16, 64, 32, 16, 16, 8, 64, 16),
          "S3": (14, 32, 16, 16, 16, 32, 112, 16)}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_SIGNATURE = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


class Build:
    """One build's K6 launcher: ``run(pairs, idx)`` moves one or two
    (src, dst) pool pairs, in one launch, or one launch a pair (``old``);
    ``idx`` holds (src_idx, dst_idx, sel) as int64/bool and as int32."""

    def __init__(self, lib, old: bool):
        self.lib, self.old = lib, old
        if old:
            self.lib.migrate_pages_launch.argtypes = list(OLD_SIGNATURE)
            self.lib.migrate_pages_launch.restype = ctypes.c_int

    def run(self, pairs, idx):
        from repro_torch.kernels.build import stream_of
        si, di, sel = idx["int32" if self.old else "int64"]
        src0, dst0 = pairs[0]
        L, B, Ms = src0.shape[:3]
        Md = dst0.shape[2]
        pb = _LL(math.prod(src0.shape[3:]) * src0.element_size())
        st = stream_of(dst0)
        if self.old:
            for src, dst in pairs:
                check(self.lib.migrate_pages_launch(
                    src.data_ptr(), dst.data_ptr(), si.data_ptr(),
                    di.data_ptr(), sel.data_ptr(), L, B, Ms, Md, pb, st),
                    "migrate_pages_launch")
            return
        src1, dst1 = pairs[-1]
        check(self.lib.migrate_pages_launch(
            src0.data_ptr(), dst0.data_ptr(), src1.data_ptr(),
            dst1.data_ptr(), len(pairs), si.data_ptr(), di.data_ptr(),
            sel.data_ptr(), L, B, Ms, Md, pb, st), "migrate_pages_launch")


def index_dtypes(torch, si, di, sel) -> dict:
    return {"int64": (si.to(torch.int64), di.to(torch.int64),
                      sel.to(torch.bool)),
            "int32": (si.to(torch.int32), di.to(torch.int32),
                      sel.to(torch.int32))}


def inputs(torch, np, rng, width: str, n_sel: int):
    """Fast and slow K and V pools of ``width`` in bf16, and indices with
    ``n_sel`` sequences selected (fast -> slow, as a demotion)."""
    L, B, Mf, Ms, pt, K, D, _ = WIDTHS[width]
    pools = [torch.randn((L, B, m, pt, K, D), device="cuda",
                         dtype=torch.bfloat16) for m in (Mf, Ms, Mf, Ms)]
    sel = torch.zeros(B, dtype=torch.bool, device="cuda")
    sel[torch.as_tensor(rng.permutation(B)[:n_sel], device="cuda")] = True
    si = torch.as_tensor(rng.integers(0, Mf, B), device="cuda")
    di = torch.as_tensor(rng.integers(0, Ms, B), device="cuda")
    return pools, index_dtypes(torch, si, di, sel)


def case_bytes(pairs, idx) -> int:
    src = pairs[0][0]
    page = math.prod(src.shape[3:]) * src.element_size()
    n_sel = int(idx["int64"][2].sum())
    return 2 * len(pairs) * src.shape[0] * n_sel * page


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--old-source", action="append", default=[],
                    metavar="NAME=PATH")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_migrate: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import copy_bandwidth, device_ms
    from repro_torch.kernels.build import build_variant, load_library
    from repro_torch.kernels.migrate.ref import migrate_pages_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = {"new": Build(load_library("serving").lib, old=False)}
    for specs, old in ((args.old_source, True), (args.source, False)):
        for spec in specs:
            name, path = spec.split("=", 1)
            builds[name] = Build(build_variant("serving", pathlib.Path(path)),
                                 old=old)
    rng = np.random.default_rng(1)
    cases = {}
    for width in WIDTHS:
        pools, idx = inputs(torch, np, rng, width, WIDTHS[width][-1])
        one = ((pools[0], pools[1]),)
        kv = ((pools[0], pools[1]), (pools[2], pools[3]))
        cases[f"{width} one pool"] = (one, idx)
        cases[f"{width} K+V"] = (kv, idx)
        if width == "S1":
            si, di, sel = idx["int64"]
            cases[f"{width} K+V none selected"] = (kv, index_dtypes(
                torch, si, di, torch.zeros_like(sel)))
    # bitwise against the plain version, on fresh destinations
    for label, (pairs, idx) in cases.items():
        want = [migrate_pages_ref(s, d.clone(), *idx["int64"])
                for s, d in pairs]
        for name, build in builds.items():
            got = [(s, d.clone()) for s, d in pairs]
            build.run(got, idx)
            torch.cuda.synchronize()
            for (_, g), w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}: {label} != plain version")
    print("every build bitwise equal to the plain version on "
          + ", ".join(cases), flush=True)
    bw = copy_bandwidth()
    print(f"measured copy bandwidth {bw / 1e12:.3f} TB/s", flush=True)
    order = list(builds) + list(reversed(builds))
    for label, (pairs, idx) in cases.items():
        nb = case_bytes(pairs, idx)
        times = {name: [] for name in builds}
        for name in order:
            times[name].append(device_ms(
                lambda: builds[name].run(pairs, idx)))
        print(f"{label}: {nb} bytes, bound {nb / HBM_BYTES_PER_S * 1e3:.5f} "
              f"ms at 3.35 TB/s, {nb / bw * 1e3:.5f} at measured copy; "
              + ", ".join(f"{n} {statistics.median(t):.4f} ms (turns "
                          + " ".join(f"{v:.4f}" for v in t) + ")"
                          for n, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
