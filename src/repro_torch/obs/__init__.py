"""Observability & fleet telemetry (torch port of ``repro/obs``; §IV-C).

  in the tick — ``stats.TierStats`` (per-tenant tiering_stat-style
               metrics), ``trace.MigrationRing`` (fixed-capacity migration
               event buffer), ``streaming.DetectorState`` (the four
               pathology detectors as windowed state) and
               ``attribution.AttributionState`` (the slowdown ledger):
               NamedTuples of tensors updated inside the tick.
  host-side  — ``stats.stats_summary`` / ``trace.decode_ring`` decoders,
               ``pathology`` offline detectors, the ``fleet`` harness that
               runs the tick across simulated hosts and rolls telemetry up
               fleet-wide, ``counterfactual`` isolated re-runs, and the
               ``export``/``dashboard`` surfaces: Chrome-trace JSON of the
               migration rings, Prometheus text exposition of fleet
               counters, and a markdown fleet dashboard CLI.
  the port's — ``spans``: host and device time of the serve, prefill and
               train steps' layers (off unless ``spans.enable()``).
"""
from repro_torch.obs.export import (chrome_trace, fleet_exposition,
                                    rollout_exposition,
                                    validate_chrome_trace,
                                    validate_exposition, write_chrome_trace)
from repro_torch.obs.stats import (TierStats, below_protection,
                                   hist_percentile, hist_percentile_j,
                                   init_stats, record_fast_entries,
                                   record_fast_exits, residency_bucket,
                                   stats_export, stats_summary, update_tick)
from repro_torch.obs.streaming import (KINDS, DetectorSignals, DetectorSpec,
                                       DetectorState, flag_summary,
                                       init_detector, make_detector,
                                       run_detector, streaming_pathologies,
                                       update_detector)
from repro_torch.obs.trace import (DIR_DEMOTE, DIR_PROMOTE, MigrationRing,
                                   decode_ring, init_ring, ring_record)

__all__ = [
    "TierStats", "below_protection", "init_stats", "record_fast_entries",
    "record_fast_exits", "residency_bucket", "stats_export", "stats_summary",
    "update_tick", "hist_percentile", "hist_percentile_j",
    "MigrationRing", "init_ring", "ring_record", "decode_ring",
    "DIR_PROMOTE", "DIR_DEMOTE",
    "KINDS", "DetectorSpec", "DetectorState", "DetectorSignals",
    "make_detector", "init_detector", "update_detector", "run_detector",
    "streaming_pathologies", "flag_summary",
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "fleet_exposition", "rollout_exposition", "validate_exposition",
]
