#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phases (35-37) alone on one card.

    python3 scripts/train_phases.py

Builds the kernels (``kernels/build.py`` ``build_all``), then calls
``chip_smoke.train_phases`` with the modules it reads (the same ``env`` as
``chip_smoke.main`` gives it) and ``chip_smoke.record_train``: K7's and
K8's gradients through their autograd Functions, Llama 3.2 1B trained at
full width and depth, mamba2-130m under the fault-tolerant driver, one
step each of Zamba2-7B, granite-moe and whisper-tiny. Prints the card's
name and power limit first and the two train-step kernel rows (JSON)
last; about 80 s after the build. Any failed check raises.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    from repro_torch.kernels.ssd_scan import ops as SSD
    from repro_torch.kernels.ssd_scan import ref as SSD_REF
    from repro_torch.models import layers as LAYERS
    from repro_torch.models import transformer as TF

    if not torch.cuda.is_available():
        print("train_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    build_all()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    env = dict(F=F, FA=FA, FA_REF=FA_REF, SSD=SSD, SSD_REF=SSD_REF,
               LAYERS=LAYERS, TF=TF, make_model=TF.make_model)
    t0 = time.perf_counter()
    rows: list = []
    CS.record_train(rows, CS.train_phases(torch, np, env))
    print(f"phases 35-37 in {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
