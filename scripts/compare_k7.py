#!/usr/bin/env python3
"""Time the flash-attention kernel (K7) of this checkout against the one of
another revision, in one process on one card.

    git archive <rev> src/repro_torch/kernels/csrc/prefill.cu | tar -x -C old/
    python3 scripts/compare_k7.py --old-source old/src/repro_torch/kernels/csrc/prefill.cu

Both sources are built with the same ``nvcc`` flags (the old one through
``kernels/build.py`` ``build_variant``) and called through the same C
launcher (``flash_attention_launch``; a revision from before the launcher
reported its route is called without the route pointer) on the same
inputs at B=1, S=4,096, causal: zamba2's heads (H=K=32, D=112) and
llama's (H=32, K=8, D=64), the shapes of ``chip_smoke.py``'s phase 17,
and h2o-danube's (H=32, K=8, D=120), the shape of its phase 31.
``--dtype bfloat16`` (the default) times the bf16 route (the wgmma
kernel), ``--dtype float32`` the f32 route (the tf32x3 kernel; before it,
the CUDA-core kernel). Each pair is timed in turns (old, new, new, old;
each turn the median of CUDA-event times over 20 back-to-back launches,
``chip_smoke.device_ms``) and checked against the plain version within
K7's bound for the dtype (2e-2 bf16, 2e-5 float32). A line gives each
kernel's fastest turn, then the turns, and the route each launcher
reported. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

SHAPES = {"zamba2": (32, 32, 112), "llama": (32, 8, 64),
          "danube": (32, 8, 120)}                           # H, K, D
B, S = 1, 4096
ROUTE_PTR = ctypes.POINTER(ctypes.c_int)
# route codes of the launcher, this revision's and earlier ones' (0 was the
# CUDA-core kernel that the tf32x3 kernel replaced)
ROUTES = {0: "cuda_cores", 1: "wgmma", 2: "tf32x3"}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def launch(lib, q, k, v, route=None):
    """q [B,H,S,D], k/v [B,K,S,D] -> causal attention, through ``lib``'s
    ``flash_attention_launch`` (the arguments ``flash_attention_cuda``
    passes; ``route``, a ``ctypes.c_int``, only where the launcher takes
    it)."""
    import torch
    from repro_torch.kernels.build import stream_of
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    extra = () if route is None else (ctypes.byref(route),)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kh,
        sq, skv, d, *strides, 1, 0, 0, ctypes.c_float(1.0 / math.sqrt(d)),
        int(q.dtype == torch.bfloat16), *extra, stream_of(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_launch: CUDA error {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=pathlib.Path, required=True)
    ap.add_argument("--dtype", choices=tuple(TOL), default="bfloat16")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_k7: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import device_ms
    from repro_torch.kernels.build import build_variant, load_library
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {"old": build_variant("prefill", args.old_source),
            "new": load_library("prefill").lib}
    routes = {"old": None, "new": ctypes.c_int(-1)}
    if b"int* route" in args.old_source.read_bytes():
        routes["old"] = ctypes.c_int(-1)
    else:
        fn = libs["old"].flash_attention_launch
        fn.argtypes = [t for t in fn.argtypes if t is not ROUTE_PTR]
    dtype, tol = getattr(torch, args.dtype), TOL[args.dtype]
    g = torch.Generator(device="cuda").manual_seed(17)
    for name, (H, K, D) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((B, H, S, D), (B, K, S, D), (B, K, S, D)))
        want = flash_attention_ref(q, k, v).float()
        errs = {}
        for which, lib in libs.items():
            got = launch(lib, q, k, v, routes[which]).float()
            errs[which] = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(f"{which} K7 off the plain version: "
                                     f"{errs[which]}")
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(device_ms(
                lambda: launch(libs[which], q, k, v, routes[which]), n=20))
        route = {w: "route not reported" if r is None
                 else f"route {ROUTES[r.value]}" for w, r in routes.items()}
        print(f"K7 [{name} H={H} K={K} D={D}, B={B} S={S}, causal, "
              f"{args.dtype}]: "
              + ", ".join(f"{w} {min(t):.4f} ms (turns "
                          + " ".join(f"{x:.4f}" for x in t)
                          + f", max abs err {errs[w]:.3g}, {route[w]})"
                          for w, t in times.items())
              + f"; new/old {min(times['new']) / min(times['old']):.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
