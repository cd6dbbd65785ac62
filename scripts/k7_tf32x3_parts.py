#!/usr/bin/env python3
"""Where the time of K7's f32 route (the tf32x3 kernel) goes, on one card.

    python3 scripts/k7_tf32x3_parts.py

Builds this checkout's ``csrc/prefill.cu`` as it is and in variants with
parts of the tf32x3 kernel taken out (textual edits of the source, each
asserted to apply), and times each at h2o-danube's f32 heads (H=32, K=8,
D=120), B=1, S=4,096, causal, through the C launcher, in two rounds
(``chip_smoke.device_ms``, the median of 10 launches). A variant that
takes a part out computes garbage; only its time is read:

* ``kernel``: the kernel as it is;
* ``consumer``: the producer warpgroup loads and stores nothing (the
  consumer alone, at its full work);
* ``consumer - S``, ``consumer - PV``, ``consumer - S - PV``: the consumer
  alone without the Q K^T products, the P V products, or either (its
  softmax, splits of p, barriers and waits);
* ``producer``: the consumer issues no products and no exp of p (the
  producer's loads, splits and stores of K and V^T alone).

Prints the card's name and power limit first, then one line per variant.

A diagnostic frozen to the tf32x3 kernel as it was first written (the
readings in PERF.md §6): its edits are exact strings of that
source, and it stops at the first one that no longer applies. It is not a
standing check; after a change to the kernel it reads nothing until its
edits are brought up to date.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

H, K, D, S = 32, 8, 120, 4096

NO_PRODUCER = [
    ("if (item < n_slots && c4 < nc4 && r < nkv)\n", "if (false)\n"),
    ("if (dc < DP / 4 && key < nkv)\n", "if (false)\n"),
    ("if (item < n_slots && c4 < nc4)\n          store_split",
     "if (false)\n          store_split"),
    ("if (dc >= DP / 4) continue;", "continue;"),
]
NO_S = [("wgmma_tf32_ss_n64(s_acc[", "if (false) wgmma_tf32_ss_n64(s_acc[")]
NO_PV = [("wgmma_tf32_pv<DP>(pv,", "if (false) wgmma_tf32_pv<DP>(pv,")]
NO_EXP = [("sacc[i] = expf(sacc[i] - m_new[rr]);",
           "sacc[i] = sacc[i] - m_new[rr];")]
VARIANTS = {
    "kernel": [],
    "consumer": NO_PRODUCER,
    "consumer - S": NO_PRODUCER + NO_S,
    "consumer - PV": NO_PRODUCER + NO_PV,
    "consumer - S - PV": NO_PRODUCER + NO_S + NO_PV,
    "producer": NO_S + NO_PV + NO_EXP,
}


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"edit does not apply: {old!r}")
        text = text.replace(old, new)
    return text


def build(kb, texts: dict) -> dict:
    """Compile every variant at once (one nvcc each), then bind each."""
    out_dir = kb.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = out_dir / (name.replace(" ", "").replace("-", "_") + ".cu")
        src.write_text(text)
        digest = hashlib.sha256(
            text.encode() + " ".join(kb.NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = kb.BUILD_DIR / f"prefill_variant_{digest}.so"
        procs[name] = (src, None if lib.exists() else subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for name, (src, proc) in procs.items():
        if proc is not None and proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n"
                               f"{proc.stderr.read()[-3000:]}")
    return {name: kb.build_variant("prefill", src)
            for name, (src, _) in procs.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k7_tf32x3_parts: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import device_ms
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.build import stream_of
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = (kb.CSRC / "prefill.cu").read_text()
    t0 = time.perf_counter()
    libs = build(kb, {n: edited(src, e) for n, e in VARIANTS.items()})
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((1, h, S, D), generator=g, device="cuda")
               for h in (H, K, K))
    out = torch.empty_like(q)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    route = ctypes.c_int(-1)

    def launch(lib):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, H,
            K, S, S, D, *strides, 1, 0, 0, ctypes.c_float(1 / math.sqrt(D)),
            0, ctypes.byref(route), stream_of(q))
        if err != 0 or route.value != 2:
            raise RuntimeError(f"launch: error {err}, route {route.value}")

    times = {n: [] for n in libs}
    for _ in range(2):
        for name, lib in libs.items():
            times[name].append(device_ms(lambda: launch(lib), n=10))
    for name, t in times.items():
        print(f"K7 tf32x3 [{name}] H={H} K={K} D={D}, B=1 S={S}, f32, "
              f"causal: {min(t):.4f} ms (rounds "
              + " ".join(f"{x:.4f}" for x in t) + ")", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
