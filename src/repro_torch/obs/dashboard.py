"""Operator dashboard (torch port of ``repro/obs/dashboard.py``): render a
fleet rollout's streamed telemetry as markdown — pathology counts by host x
tenant x kind, first-flag ticks, the slowdown attribution ledger, and
fast-residency percentiles decoded from the tick's log2 histograms.

Runnable as a CLI over a small self-contained demo fleet:

    PYTHONPATH=src python -m repro_torch.obs.dashboard --hosts 4 --noisy \
        --device cuda --trace fleet.trace.json --prom fleet.prom

``--trace`` writes the migration rings as Chrome-trace JSON (open in
ui.perfetto.dev); ``--prom`` writes Prometheus text exposition; ``--device
cpu`` runs the fleet on the CPU.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import TieringConfig
from repro_torch.core.workloads import (ChurnSlot, build_churn_schedule,
                                        cache_like, spark_like, thrasher,
                                        web_like)
from repro_torch.obs.attribution import COMPONENTS
from repro_torch.obs.export import (rollout_exposition,
                                    validate_chrome_trace,
                                    validate_exposition, write_chrome_trace)
from repro_torch.obs.fleet import (RolloutSummary, fleet_rollout,
                                   stack_schedules)
from repro_torch.obs.stats import hist_percentile
from repro_torch.obs.streaming import KINDS

DEMO_FOOT = (32, 40, 40, 24)


def demo_fleet(hosts: int = 4, ticks: int = 160, noisy: bool = False,
               chunk: int = 64, k_max: int = 32, impl: Optional[str] = None,
               device="cuda") -> Tuple[TieringConfig, RolloutSummary]:
    """A small mixed fleet (web/cache/spark slots, one mid-run slot churn
    per odd host) rolled out with streaming detectors. ``noisy=True``
    replaces slot 0 of the last host with the §V-B5 thrasher (late arrival,
    squeezed under slot 0's upper bound) so the demo flags a pathology.
    ``impl``/``device`` as for ``fleet_rollout``."""
    total = sum(DEMO_FOOT)
    cfg = TieringConfig(n_tenants=4, n_fast_pages=int(total * 1.15),
                        n_slow_pages=total, lower_protection=(8, 12, 12, 8),
                        upper_bound=(24, 0, 0, 0), migration_cost=0.005)
    mk = (web_like, cache_like, spark_like, web_like)
    schedules = []
    for h in range(hosts):
        slots: List[ChurnSlot] = []
        for i, f in enumerate(DEMO_FOOT):
            if h % 2 and i == 2:   # odd hosts churn slot 2 mid-run
                eps = [(0, ticks // 2), (ticks * 5 // 8, ticks)]
            else:
                eps = [((h + i) % 4, ticks)]
            slots.append(ChurnSlot(mk[(h + i) % 4](f), eps))
        if noisy and h == hosts - 1:
            slots[0] = ChurnSlot(thrasher(DEMO_FOOT[0], fast_share=12),
                                 [(ticks // 5, ticks)])
        schedules.append(build_churn_schedule(slots, ticks))
    want, rates = stack_schedules(schedules)
    return cfg, fleet_rollout(cfg, want, rates, ticks, chunk=chunk,
                              k_max=k_max, impl=impl, device=device)


# ------------------------------------------------------------ rendering ----
def _md_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    head = "| " + " | ".join(headers) + " |"
    sep = "|" + "|".join("---" for _ in headers) + "|"
    body = ["| " + " | ".join(str(c) for c in r) + " |" for r in rows]
    return "\n".join([head, sep] + body)


def render_dashboard(roll: RolloutSummary,
                     quantiles: Sequence[float] = (0.5, 0.95, 0.99)) -> str:
    """The fleet roll-up as markdown: overview, pathology counters
    (host x tenant x kind from the streamed DetectorState), the slowdown
    attribution ledger (stall units by cause, fleet component shares and
    sketch percentiles), and fast-residency percentiles from the in-graph
    log2 histograms."""
    parts = ["# Fleet telemetry roll-up", ""]
    parts.append(_md_table(
        ["hosts", "ticks", "host-ticks/s", "mean latency", "migrations/tick"],
        [[roll.n_hosts, roll.ticks, f"{roll.host_ticks_per_s:,.0f}",
          f"{float(np.mean(roll.latency_mean)):.3f}",
          f"{float(np.mean(roll.migrations_per_tick)):.2f}"]]))
    parts.append("")

    parts.append("## Pathologies (streaming detectors)")
    if roll.detector is None:
        parts.append("_rollout ran with detect=False_")
    else:
        counts = roll.pathology_counts()
        parts.append(_md_table(
            ["kind", "tenants flagged (fleet-wide)"],
            [[k, v] for k, v in counts.items()] or [["(none)", 0]]))
        flagged = roll.tenants_flagged()
        if flagged:
            first = roll.pathology_first_flag()
            ticks_held = roll.pathology_flag_ticks()
            rows = []
            for h, t in flagged:
                for p in roll.host_pathologies(h):
                    if p.tenant != t:
                        continue
                    k = KINDS.index(p.kind)
                    rows.append([h, t, p.kind, f"{p.severity:.2f}",
                                 int(first[h, t, k]),
                                 int(ticks_held[h, t, k])])
            parts.append("")
            parts.append(_md_table(
                ["host", "tenant", "kind", "severity", "first flag tick",
                 "flag ticks"], rows))
    parts.append("")

    parts.append("## Slowdown attribution (stall units by cause)")
    if roll.attribution is None:
        parts.append("_rollout ran with attrib=False_")
    else:
        comp = roll.attribution_components()        # [H, T, C]
        total = roll.attribution_totals()           # [H, T]
        fhit = roll.fast_hit_fraction()             # [H, T]
        names = list(COMPONENTS)
        rows = []
        for h in range(roll.n_hosts):
            for t in range(comp.shape[1]):
                rows.append([h, t, int(total[h, t])]
                            + [int(c) for c in comp[h, t]]
                            + [f"{fhit[h, t]:.3f}"])
        parts.append(_md_table(
            ["host", "tenant", "stall units"] + names + ["fast-hit"], rows))
        parts.append("")
        rup = roll.attribution_rollup()
        shares = rup["component_shares"]
        parts.append(_md_table(
            ["fleet stall units"] + names
            + [f"p{int(q * 100)}/tick" for q in quantiles] + ["conserved"],
            [[rup["stall_units_total"]]
             + [f"{shares[k]:.1%}" for k in names]
             + [f"{v:.0f}" for v in roll.stall_percentiles(quantiles)]
             + [rup["conserved"]]]))
    parts.append("")

    parts.append("## Fast-tier residency (ticks, log2-bucket lower edges)")
    hist = roll.final_state.stats.resid_hist.cpu().numpy()   # [H, T, NB]
    rows = []
    for h in range(roll.n_hosts):
        ps = [hist_percentile(hist[h], q) for q in quantiles]
        for t in range(hist.shape[1]):
            rows.append([h, t] + [f"{p[t]:.0f}" for p in ps])
    parts.append(_md_table(
        ["host", "tenant"] + [f"p{int(q * 100)}" for q in quantiles], rows))
    parts.append("")
    return "\n".join(parts)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a demo fleet rollout as a markdown dashboard.")
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=160)
    ap.add_argument("--noisy", action="store_true",
                    help="inject a thrasher on the last host")
    ap.add_argument("--trace", metavar="PATH",
                    help="also write Chrome-trace JSON of the migration "
                         "rings (open in ui.perfetto.dev)")
    ap.add_argument("--prom", metavar="PATH",
                    help="also write Prometheus text exposition")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fleet (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg, roll = demo_fleet(args.hosts, args.ticks, noisy=args.noisy,
                           device=args.device)
    print(render_dashboard(roll))

    if args.trace:
        events = {h: roll.host_migrations(h)[0] for h in range(roll.n_hosts)}
        trace = write_chrome_trace(args.trace, events,
                                   t_resident=cfg.t_resident,
                                   horizon=args.ticks)
        n = validate_chrome_trace(trace)
        print(f"wrote {args.trace}: {n} trace events (validated)")
    if args.prom:
        text = rollout_exposition(roll)
        n = validate_exposition(text)
        with open(args.prom, "w") as f:
            f.write(text)
        print(f"wrote {args.prom}: {n} samples (validated)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
