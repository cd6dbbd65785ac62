"""``python -m repro_torch.analysis`` — audit the port's tick, fleet and
kernel calls (torch port of ``python -m repro.analysis``).

Default run: record every real target (the unified tick: 4 policy modes x
both ownership providers and the four hotness providers; the L=262,144 /
T=64 scale point; the fleet chunk; the eight kernel wrappers; on the card
the kernel-backed tick ``tick:cuda:equilibria``), run the purity, dtype,
overflow, donation and launch passes and the constancy sweeps, and
AST-lint ``src/repro_torch``. On the card the purity pass also runs every
target under ``torch.cuda.set_sync_debug_mode("warn")`` and a child
process tries to capture the cuda tick at C1's size (T = 64 over
L = 262,144) in a CUDA graph, one per controller phase, and the same tick
at T = 32 and 64 runs purity under sync debug and the constancy check in
T, each controller phase on its own.
Findings print keyed as ``pass:target:slug``.

  --gate            exit 1 on any finding not in the committed baseline
                    (analysis/baseline.json); stale baseline keys warn.
  --write-baseline  accept the current findings as the new baseline (the
                    other device's keys are kept).
  --fixture NAME    audit a known-bad fixture instead of the real targets
                    (purity|dtype|overflow|constancy|donation|lint|clean);
                    bad fixtures are never baselined, so --gate exits
                    non-zero iff the fixture is flagged; the clean fixture
                    (the real small tick) is held to the real tick's
                    baseline entries.
  --fast            skip the scale + fleet targets (quick local loop); on
                    the card the fleet's donation contract still runs.
  --json            machine-readable report on stdout.
  --device          cuda (the default; raises without a card) or cpu.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Tuple

from repro_torch.analysis import constancy as C
from repro_torch.analysis import fixtures as FX
from repro_torch.analysis import lint as LI
from repro_torch.analysis.findings import (BASELINE_PATH, Finding, Report,
                                           load_baseline, write_baseline)
from repro_torch.analysis.op_audit import (CAPTURE_PHASES, capture_pass,
                                           capture_verdict,
                                           carry_dtypes, donation_pass,
                                           dtype_pass, launch_pass,
                                           overflow_pass, purity_pass,
                                           start_capture_probe)
from repro_torch.analysis.targets import AuditTarget
from repro_torch.analysis.walk import (OpTrace, launch_counts, named_leaves,
                                       record)
from repro_torch.device import resolve_device

_PORT_SRC = os.path.normpath(
    os.path.join(os.path.dirname(__file__), os.pardir))   # src/repro_torch
CAPTURE_TARGET = "tick:cuda:C1:capture"


def _result_leaves(t: AuditTarget, result) -> list:
    """(name, tensor) of a call's result: the carried state under its own
    name, every other part as ``out[i]``."""
    parts = result if isinstance(result, tuple) else (result,)
    out = []
    for i, part in enumerate(parts):
        carried = t.carry is not None and i == t.carry[1]
        out += named_leaves(part, t.names[t.carry[0]] if carried
                            else f"out[{i}]")
    return out


def audit_target(t: AuditTarget, report: Report) -> List[OpTrace]:
    """The purity, dtype, overflow and launch passes over one target;
    returns the traces the purity and dtype passes read (one per phase).
    Its donation contract is the caller's to run."""
    report.audited.add(t.name)
    cuda = any(x.is_cuda for args in t.phases
               for _, x in named_leaves(args, ""))
    traces = None
    if t.input_ivals is not None:
        traces = overflow_pass(t.fn, t.phases, t.names, t.name, report,
                               t.input_ivals, t.carry, t.horizon)
    else:
        for args in t.phases:   # warm: lazily built constants, libraries
            t.fn(*args)
    if traces is None or cuda:
        # on the card, a run of its own under sync debug (the interval
        # shadow reads values on the host)
        traces = [record(t.fn, *args, sync_debug=cuda) for args in t.phases]
    purity_pass(traces, t.name, report)
    carry, outputs = {}, {}
    for args, tr in zip(t.phases, traces):
        if t.carry is not None:
            for name, d_in, d_out in carry_dtypes(
                    args[t.carry[0]], tr.result[t.carry[1]],
                    t.names[t.carry[0]]):
                carry[name] = (name, d_in, d_out)
        for name, x in _result_leaves(t, tr.result):
            outputs[name] = (name, x.dtype)
    dtype_pass(traces, t.name, report, carry=list(carry.values()),
               outputs=list(outputs.values()))
    if cuda and t.kernel:
        launch_pass(traces[0], t.kernel, t.name, report)
    return traces


def _constancy(name: str, diff: List[str], report: Report,
               verbose: bool) -> None:
    report.audited.add(name)
    if diff:
        report.add(Finding("constancy", name, "sweep", "; ".join(diff)[:500]))
    if verbose:
        print(f"  constancy {name}: {'VIOLATED' if diff else 'ok'}",
              file=sys.stderr)


def run_audit(device="cuda", fast: bool = False, verbose: bool = False
              ) -> Tuple[Report, dict]:
    """The real audit. Returns the report and what it measured: per
    target its ops and kernel launches per call (``targets``), each
    constancy sweep's signatures (``constancy``), each donation contract's
    readings (``memory``), the kernel launches of the whole audit
    (``launches``) and, on the card, K7's launches by route
    (``k7_routes``) and the capture verdict (``capture``).

    ``fast`` skips the scale and fleet targets; on the card the fleet
    chunk's donation contract (``memory_allocated`` not growing tick over
    tick) still runs, as it is cheap and only the card can read it."""
    from repro_torch.analysis import targets as TG
    from repro_torch.kernels.flash_attention.ops import flash_attention
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    report = Report(device=dev.type)
    info: dict = {"targets": {}, "constancy": {}, "memory": {}}
    before = launch_counts()
    routes = dict(flash_attention.routes)
    # the capture probe's child runs beside the audit
    probe = start_capture_probe() if cuda else None
    targets = TG.all_targets(dev, scale=not fast, fleet=not fast)
    if fast and cuda:
        fleet = TG.fleet_chunk_target(device=dev)
        info["memory"][fleet.name] = fleet.donation(report)
    for t in targets:
        t0 = time.perf_counter()
        traces = audit_target(t, report)
        if t.donation is not None:
            info["memory"][t.name] = t.donation(report)
        info["targets"][t.name] = {
            "ops": traces[0].n_ops,
            "launches": {k: v for k, v in traces[0].launches.items() if v},
            "syncs": sum(op.syncs for tr in traces for op in tr.ops),
            "s": time.perf_counter() - t0}
        if verbose:
            print(f"  audited {t.name:28s} "
                  f"({time.perf_counter() - t0:.2f}s)", file=sys.stderr)
    for name, (build, params) in TG.tick_constancy_sweeps(dev).items():
        _ok, sigs, diff = C.check_constant(build, params)
        info["constancy"][name] = sigs
        _constancy(name, diff, report, verbose)
    if cuda:
        # the cuda tick at C1's size: purity under sync debug and
        # constancy in T, each controller phase on its own
        c1 = {T: audit_target(TG.c1_tick_target(T, dev), report)
              for T in TG.C1["T"]}
        for k, label in enumerate(CAPTURE_PHASES):
            name = "tick:cuda:C1:T" + ("" if k == 0 else f":{label}")
            sigs = [(T, C.signature_of(trs[k])) for T, trs in c1.items()]
            info["constancy"][name] = sigs
            _constancy(name, C.compare(sigs), report, verbose)
        report.audited.add(CAPTURE_TARGET)
        info["capture"] = capture_verdict(probe)
        capture_pass(info["capture"], CAPTURE_TARGET, report)
    LI.lint_paths([_PORT_SRC], report,
                  root=os.path.normpath(os.path.join(_PORT_SRC, os.pardir)))
    after = launch_counts()
    info["launches"] = {k: after[k] - before[k] for k in after}
    info["k7_routes"] = {k: v - routes[k]
                         for k, v in flash_attention.routes.items()}
    return report, info


def _run_fixture(name: str, report: Report, device) -> List[str]:
    """Audit one fixture; returns the baseline it is held to."""
    if name == "purity":
        t = FX.bad_purity(device)
        purity_pass([record(t.fn, *t.phases[0])], t.name, report)
    elif name == "dtype":
        t = FX.bad_dtype(device)
        tr = record(t.fn, *t.phases[0])
        dtype_pass([tr], t.name, report, carry=carry_dtypes(
            t.phases[0][0], tr.result[0], "counter"))
    elif name == "overflow":
        for t in (FX.bad_overflow_carry(device), FX.bad_overflow_f32(device)):
            overflow_pass(t.fn, t.phases, t.names, t.name, report,
                          t.input_ivals, t.carry, t.horizon)
    elif name == "constancy":
        ok, _sigs, diff = C.check_constant(
            lambda T: FX.bad_constancy_build(T, device), (2, 5))
        if not ok:
            report.add(Finding("constancy", "fixture:constancy", "sweep",
                               "; ".join(diff)[:500]))
    elif name == "donation":
        fn, args, donate = FX.bad_donation(device)
        donation_pass(fn, args, donate, "fixture:donation", report)
    elif name == "lint":
        for tag, src in (("tenant", FX.BAD_LINT_TENANT_LOOP),
                         ("np", FX.BAD_LINT_NP_IN_GRAPH),
                         ("seam", FX.BAD_LINT_SEAM_DEFAULT)):
            report.extend(LI.lint_source(src, f"fixture:lint:{tag}",
                                         in_core=True))
    elif name == "clean":
        audit_target(FX.clean_tick(device), report)
        ok, _sigs, diff = C.check_constant(
            lambda T: FX.good_constancy_build(T, device), (2, 5))
        if not ok:
            report.add(Finding("constancy", "fixture:clean", "sweep",
                               "; ".join(diff)[:500]))
        fn, args, donate = FX.good_donation(device)
        donation_pass(fn, args, donate, "fixture:clean", report)
        report.extend(LI.lint_source(FX.CLEAN_LINT, "fixture:clean",
                                     in_core=True))
        real = ":tick:static:equilibria:"
        return [k.replace(real, ":fixture:clean:") for k in load_baseline()
                if real in k]
    else:
        raise SystemExit(f"unknown fixture {name!r}; "
                         f"choose from {FX.FIXTURES}")
    return []


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the port's tick, fleet and kernel "
                    "calls.")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 on findings not in the committed baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings as the baseline")
    ap.add_argument("--fixture", choices=FX.FIXTURES,
                    help="audit a known-bad fixture instead of real targets")
    ap.add_argument("--fast", action="store_true",
                    help="skip the scale + fleet targets")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    report = Report(device=device.type)
    if args.fixture:
        baseline = _run_fixture(args.fixture, report, device)
    else:
        report, _info = run_audit(device, fast=args.fast,
                                  verbose=args.verbose)
        baseline = load_baseline()

    if args.write_baseline and not args.fixture:
        path = write_baseline(report)
        print(f"baseline written: {path} ({len(report.keys())} keys)")

    new = report.new_vs(baseline)
    stale = report.stale_vs(baseline)

    if args.as_json:
        out = report.to_json()
        out["new"] = [f.key for f in new]
        out["stale"] = stale
        print(json.dumps(out, indent=2))
    else:
        n_base = len(report.findings) - len(new)
        print(f"analysis: {len(report.findings)} findings "
              f"({len(new)} new, {n_base} baselined), "
              f"{len(report.notes)} notes")
        for f in new:
            print(f"NEW {f}")
        if args.verbose:
            for f in sorted(report.findings, key=lambda f: f.key):
                if f not in new:
                    print(f"    {f.key}  [baselined]")
            for n in report.notes:
                print(f"note: {n}")
        for k in stale:
            print(f"stale baseline entry (no longer fires): {k}")

    if args.gate and new:
        print(f"GATE: {len(new)} finding(s) not in baseline "
              f"({BASELINE_PATH})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
