"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, the metrics, and the result line.

Everything that belongs to a cell is found by name: the cell's entry and
its metrics in ``BENCHMARK.json``, its traffic in ``workloads/<cell>.json``,
its configuration in the file ``BENCHMARK.json`` names, its path (decode,
prefill, train) in ``paths/<path>.py``, and each per-layer metric's reader
in ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    """The run needs more cards than this machine shows."""


class Bench:
    """A run's inputs and what its path hands back."""

    def __init__(self, cell: dict, conf: dict, seed: int, seconds: float,
                 trace: bool, device, t_start: float):
        from portbench.model import model_config
        from portbench.trace import Tracer
        self.cell, self.conf = cell, conf
        self.sizes = conf["port"]
        self.cfg = model_config(conf)
        self.seed, self.seconds, self.device = seed, seconds, device
        self.tracer = Tracer(trace)
        self.t_start = t_start
        self.setup_s = None
        self.e2e: dict = {}            # end-to-end readings by name
        self.record: dict = {}         # what the per-layer readers read
        self.compared: dict = {}       # name -> (value, limit)
        self.attempted = self.failed = 0
        self.memory_peak = 0
        self.alloc_retries = None      # the CUDA allocator's, at the close
        self.control = False           # also read the fp8 control's numbers

    def model(self):
        from portbench import model
        return model.build(self.conf, self.cfg, self.seed, self.device)

    def setup_done(self) -> None:
        """Set-up ends here: everything after is the measured window."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def sync(self) -> None:
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def read_memory_peak(self) -> None:
        """The peak of allocated memory, and the times the allocator freed
        its cache and retried an allocation, read when the window closes."""
        import torch
        if torch.device(self.device).type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated())
            self.alloc_retries = int(
                torch.cuda.memory_stats().get("num_alloc_retries", 0))

    def compare(self, name: str, value: float) -> None:
        self.compared[name] = (value, self.cell["limits"][name])

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.compared.values())


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, man: dict):
    """(the cell's entry, its workload file, its configuration's file)."""
    entry = find(man["workloads"], name, "workload")
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    conf = load_json(ROOT / find(man["configs"], entry["config"],
                                 "config")["file"])
    return entry, cell, conf


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", man=None, t_start=None, cell=None, conf=None,
             control: bool = False) -> Bench:
    """Set up and run one cell once; ``cell`` and ``conf`` replace the
    files' contents (the tests run small copies on the CPU)."""
    import torch
    man = man or manifest()
    entry, cell_file, conf_file = load_cell(name, man)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < entry["chips"]:
            raise NoCard(f"{name} needs {entry['chips']} CUDA device(s); "
                         f"torch.cuda.is_available() is "
                         f"{torch.cuda.is_available()}")
    bench = Bench(cell or cell_file, conf or conf_file, seed, seconds, trace,
                  device, time.perf_counter() if t_start is None else t_start)
    bench.control = control
    path = importlib.import_module(f"portbench.paths.{bench.cell['path']}")
    path.run(bench)
    return bench


def result(bench: Bench, name: str, man: dict, trace: bool) -> dict:
    """The result line of a run: the cell's end-to-end metrics (trace 0) or
    its per-layer metrics (trace 1), the device, and the numbers compared."""
    import torch
    metrics = {}
    if trace:
        for m in man["per_layer"]:
            if applies(m, name):
                value = metric_reader(m["name"])(bench)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(bench.e2e, setup_s=bench.setup_s)
        for m in man["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = torch.device(bench.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": bench.memory_peak}
    out = {"correct": bench.correct, "attempted": bench.attempted,
           "failed": bench.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = bench.tracer.busy_s()
        device["window_s"] = bench.tracer.window_s()
        out["breakdown"] = bench.tracer.breakdown()
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in bench.compared.items()}
    return out


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level modules among ``modules`` (the process's)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None, t_start=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = manifest()
    try:
        bench = run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), man=man, t_start=t_start)
    except NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = loaded_forbidden()
    if found:
        print(f"portbench: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    out = result(bench, args.workload, man, bool(args.trace))
    print(f"allocator retries {bench.alloc_retries!r}", file=sys.stderr)
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
