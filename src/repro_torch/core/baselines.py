"""Baseline tiering policies the paper compares against.

All baselines run through the same engine (core/engine.py) selected by
``mode`` so comparisons are apples-to-apples:

  * ``tpp`` — TPP / upstream Linux (Maruf et al., ASPLOS'23): watermark-driven
    demotion picks the *system-wide* coldest pages (global LRU, no per-tenant
    quotas); promotion is NUMA-hint-fault-style — any slow page that looks hot
    is promoted, budgeted globally, first-come-first-served. No protections,
    no bounds, no thrash mitigation. This is the paper's primary baseline.
  * ``memtis`` — MEMTIS-like (SOSP'23) multi-tenancy: only an *upper limit*
    of fast-tier usage per cgroup, enforced at allocation/overage; no
    work-conserving lower protection, no promotion regulation.
  * ``static`` — tier fixed at allocation time (first-touch), no migration:
    the no-tiering lower bound.
  * ``equilibria`` — the paper's system (the default in core/engine.py).

Ablation flags on TieringConfig (enable_protection / enable_upper_bound /
enable_promo_throttle / enable_thrash_mitigation) turn individual Equilibria
mechanisms off for component studies (§V-B).
"""
from repro_torch.core.engine import MODES, make_tick, run_engine  # noqa: F401

BASELINE_MODES = ("tpp", "memtis", "static")
