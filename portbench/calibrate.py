"""Readings for setting a cell's limits: the numbers the check compares,
for the program and for the fp8 control, on many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 1]

Each seed is a whole run of the cell (its own weights and traffic) with a
short window; the control is the plain reference computed with every
weight product in float8 e4m3, read on the same sequences. One JSON line
per seed.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import portbench  # noqa: E402

portbench.configure_environment()


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        bench = harness.run_cell(args.workload, seed, args.seconds, False,
                                 control=True)
        print(json.dumps({
            "seed": seed, "correct": bench.correct,
            "compared": {k: v for k, (v, _) in bench.compared.items()},
            "control": {k: v for k, v in bench.record.items()
                        if k.startswith(("control_", "fault_"))},
            "e2e": bench.e2e, "setup_s": bench.setup_s,
            "memory_peak_bytes": bench.memory_peak,
            "alloc_retries": bench.alloc_retries}), flush=True)
        del bench
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
