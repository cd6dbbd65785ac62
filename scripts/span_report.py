#!/usr/bin/env python3
"""Run one cell of the benchmark with the port's span recorder on over its
window, and print what the spans read.

    python3 scripts/span_report.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> --spans <0|1>

The cell runs through ``portbench.harness.run_cell`` as
``portbench/run.py`` runs it, with two differences:

* with ``--spans 1``, the recorder (``repro_torch/obs/spans.py``) is reset
  and switched on when the window opens (``Bench.setup_done``) and off when
  it closes (``Bench.read_memory_peak``);
* with ``--trace 1``, each profiled span is reduced without the profiler's
  GPU user-annotation events: in a profiled step every recorder span opens
  a ``record_function`` range, which kineto mirrors onto the device's
  timeline, and such a range is no device work. The unfiltered reduction's
  busy time and launches are printed beside, to show what the filter keeps
  out.

Prints the harness's result line first (stdout), then one JSON line:
``layers`` (the layer numbers of ``LAYERS``, each left out where its spans
never ran), ``summary`` (``spans.summary()``), ``host_step_ms`` (the
harness's mean unprofiled step), ``host`` (what the host did over the
window, ``host_window``: this process's CPU use and context switches, the
machine's busy, idle and stolen shares, its CPU model, clock, cores, load
and torch's threads), and with ``--trace 1`` the idle gaps of
the profiled spans by the kind of host label that holds them and the
unfiltered reduction's numbers. The summary's rows also go to stderr,
after the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import pathlib
import resource
import subprocess
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]

# name -> (the step span, the spans summed, the summary's column); each
# number is the spans' time per step of the step span
LAYERS = {
    "mamba_ms.decode": ("serve.step", ("serve.mamba",), "device_ms"),
    "attention_ms.decode": ("serve.step", ("serve.attention",), "device_ms"),
    "tiering_ms.decode": ("serve.step", ("serve.alloc", "serve.tiering"),
                          "device_ms"),
    "mamba_glue_ms.prefill": ("prefill.step", ("mamba.block",),
                              "self_device_ms"),
    "backward_ms.train": ("train.step", ("train.backward",), "device_ms"),
    "optimizer_ms.train": ("train.step", ("train.optimizer",), "device_ms"),
}


def per_step(summary: dict, step: str, names, column: str):
    """The spans ``names``' ``column`` summed over their steps, per step of
    ``step``; None where one of them never ran or has no such time."""
    rows = [summary.get(n) for n in names]
    if step not in summary or any(r is None or r[column] is None
                                  for r in rows):
        return None
    return sum(r[column] * r["steps"] for r in rows) / summary[step]["steps"]


def host_enqueue_share(summary: dict):
    """Percent of the training step's host time spent before it waits for
    the device: 100 (train.step - train.sync) / train.step, host clock."""
    step, sync = summary.get("train.step"), summary.get("train.sync")
    if step is None or sync is None:
        return None
    total = step["host_ms"] * step["steps"]
    return 100.0 * (total - sync["host_ms"] * sync["steps"]) / total


def layers(summary: dict) -> dict:
    out = {name: per_step(summary, *spec) for name, spec in LAYERS.items()}
    out["host_enqueue_share.train"] = host_enqueue_share(summary)
    return {k: v for k, v in out.items() if v is not None}


def host_step_ms(record: dict):
    """The mean host time of the window's unprofiled steps (a decode step,
    a prefill request, a training step) as the harness timed them."""
    times = [t[-2] for key in ("steps", "requests", "train_steps")
             for t in record.get(key, ()) if not t[-1]]
    return 1e3 * sum(times) / len(times) if times else None


# the fields of /proc/stat's "cpu" line, in clock ticks
PROC_STAT = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
             "steal")


def _read(path: str):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def host_state() -> dict:
    """The host as this process sees it now: the CPU model and the mean
    clock of its cores (/proc/cpuinfo), the cores the machine has and those
    this process may run on, its threads, torch's intra-op threads, the
    load average, the machine's CPU time by kind since boot (/proc/stat,
    clock ticks), this process's CPU seconds (all its threads) and its
    context switches. What the platform does not give is None."""
    import torch
    ru = resource.getrusage(resource.RUSAGE_SELF)
    info = _read("/proc/cpuinfo") or ""
    models = [ln.split(":", 1)[1].strip() for ln in info.splitlines()
              if ln.startswith("model name")]
    mhz = [float(ln.split(":", 1)[1]) for ln in info.splitlines()
           if ln.startswith("cpu MHz")]
    stat = (_read("/proc/stat") or "").splitlines()
    ticks = ([int(v) for v in stat[0].split()[1:1 + len(PROC_STAT)]]
             if stat and stat[0].startswith("cpu ") else None)
    status = _read("/proc/self/status") or ""
    threads = [int(ln.split()[1]) for ln in status.splitlines()
               if ln.startswith("Threads:")]
    return {
        "t": time.perf_counter(), "cpu_model": models[0] if models else None,
        "cpu_mhz": sum(mhz) / len(mhz) if mhz else None,
        "cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
        "threads": threads[0] if threads else None,
        "torch_threads": torch.get_num_threads(),
        "loadavg": list(os.getloadavg()),
        "proc_stat": dict(zip(PROC_STAT, ticks)) if ticks else None,
        "cpu_s": ru.ru_utime + ru.ru_stime, "ctx_voluntary": ru.ru_nvcsw,
        "ctx_involuntary": ru.ru_nivcsw}


def host_window(a: dict, b: dict) -> dict:
    """What the host did between two ``host_state`` readings: the wall
    seconds; this process's CPU seconds per wall second (1.0: one core
    busy all along) and its context switches per second (voluntary: it
    waited; involuntary: it was preempted); the machine's shares of its CPU
    time that were busy, idle (idle and iowait) and stolen by the
    hypervisor; and the fixed fields at both ends."""
    wall = b["t"] - a["t"]
    out = {"wall_s": wall,
           "process_cores": (b["cpu_s"] - a["cpu_s"]) / wall,
           "ctx_voluntary_per_s": (b["ctx_voluntary"] - a["ctx_voluntary"])
           / wall,
           "ctx_involuntary_per_s": (b["ctx_involuntary"]
                                     - a["ctx_involuntary"]) / wall}
    if a["proc_stat"] and b["proc_stat"]:
        d = {k: b["proc_stat"][k] - a["proc_stat"][k] for k in PROC_STAT}
        total = sum(d.values()) or 1
        idle = d["idle"] + d["iowait"]
        out.update(machine_busy=(total - idle - d["steal"]) / total,
                   machine_idle=idle / total, machine_steal=d["steal"] / total)
    for k in ("cpu_model", "cpus", "affinity", "threads", "torch_threads",
              "cpu_mhz", "loadavg"):
        out[k] = [a[k], b[k]] if a[k] != b[k] else a[k]
    return out


def gap_kinds(spans_) -> dict:
    """Idle seconds of the profiled spans' labelled gaps: under a recorder
    span (``eq.*``), under another host op, under none."""
    out = {"eq": 0.0, "host_op": 0.0, "no_host_op": 0.0}
    for s in spans_:
        for label, sec in s.gaps.items():
            kind = ("no_host_op" if label == "no host op" else
                    "eq" if label.startswith("eq.") else "host_op")
            out[kind] += sec
    return out


class DeviceWork:
    """A profile whose events leave out the GPU user annotations."""

    def __init__(self, prof):
        self.prof = prof

    def events(self):
        from torch.autograd import DeviceType
        return [e for e in self.prof.events()
                if not (e.device_type == DeviceType.CUDA
                        and getattr(e, "is_user_annotation", False))]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"no nvidia-smi ({e})"


def report(name: str, seed: int, seconds: float, trace: bool,
           spans_on: bool, **run_cell_kw):
    """Run cell ``name`` once (``run_cell_kw`` as ``harness.run_cell``
    takes them); returns (the result line, the spans' line)."""
    if str(ROOT) not in sys.path:
        sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    from portbench import trace as PT
    from repro_torch.obs import spans

    unfiltered = []                 # (label, busy s, launches) of each span
    reduce = PT.reduce

    def filtered(prof, label, wall, info):
        raw = reduce(prof, label, wall, info)
        unfiltered.append((label, raw.busy_s, raw.launches))
        return reduce(DeviceWork(prof), label, wall, info)

    setup_done = harness.Bench.setup_done
    read_memory_peak = harness.Bench.read_memory_peak

    host = {}

    def opened(bench):
        setup_done(bench)
        host["open"] = host_state()
        if spans_on:
            spans.reset()
            spans.enable()

    def closed(bench):
        spans.disable()
        host["close"] = host_state()
        read_memory_peak(bench)

    spans.reset()
    PT.reduce = filtered
    harness.Bench.setup_done = opened
    harness.Bench.read_memory_peak = closed
    try:
        man = run_cell_kw.pop("man", None) or harness.manifest()
        bench = harness.run_cell(name, seed, seconds, trace, man=man,
                                 **run_cell_kw)
        out = harness.result(bench, name, man, trace)
    finally:
        spans.disable()
        PT.reduce = reduce
        harness.Bench.setup_done = setup_done
        harness.Bench.read_memory_peak = read_memory_peak
    if torch.device(bench.device).type == "cuda":
        torch.cuda.synchronize()
    summary = spans.summary()
    extra = {"spans_on": spans_on, "layers": layers(summary),
             "summary": summary, "host_step_ms": host_step_ms(bench.record),
             "host": (host_window(host["open"], host["close"])
                      if len(host) == 2 else None)}
    if trace:
        extra["gaps"] = gap_kinds(bench.tracer.spans)
        extra["unfiltered"] = unfiltered
    return out, extra


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import portbench
    portbench.configure_environment()
    print(card(), file=sys.stderr, flush=True)
    out, extra = report(args.workload, args.seed, args.seconds,
                        bool(args.trace), bool(args.spans), t_start=T_START)
    for name, row in extra["summary"].items():
        print(f"span {name} {json.dumps(row)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    print(json.dumps(extra), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
