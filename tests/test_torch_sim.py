"""Whole runs of the port held against the JAX reference (CPU, small sizes).

* ``static_small`` reproduces ``tests/golden/static_small.json`` through the
  port's ``simulate`` with ``impl="ref"`` (the kernel-backed strategy on the
  kernels' plain versions) and ``impl="batched"`` (the mirror of the
  reference's jnp default).
* ``stacked16`` over 60 ticks in all four modes: every integer ``SimResult``
  field, the ``tier_stat`` summary and the decoded migration ring equal the
  reference's ``simulate(..., impl="pallas_ref")`` bitwise. The f32 perf
  model (throughput, latency) is held within rtol 1e-5 / atol 1e-4: its
  per-tenant sums go through a float cumsum whose association torch and XLA
  do not share.
* The port's copies of the trace generators and of the pathology detectors
  give the reference's outputs.
"""
import functools
import json

import numpy as np
import pytest

from repro.core import simulator as JSIM
from repro.core import workloads as JW
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.core import simulator as TSIM
from repro_torch.core import workloads as TW
from test_golden_trace import GOLDEN_DIR, _collect, _diff

MODES = ("equilibria", "tpp", "memtis", "static")
INT_FIELDS = ("fast_usage", "slow_usage", "promotions", "demotions",
              "thrash_events", "attempted", "pool_free", "active")
FLOAT_FIELDS = ("throughput", "latency", "promo_scale")


@pytest.mark.parametrize("impl", ["ref", "batched"])
def test_static_small_golden(impl):
    """The reference's ``_static_small`` scenario (tests/test_golden_trace.py)
    through the port, diffed against the committed golden fixture."""
    cfg = TCfg(n_tenants=3, n_fast_pages=128, n_slow_pages=256,
               lower_protection=(48, 48, 0), upper_bound=(0, 64, 0))
    tenants = [TW.microbenchmark(80), TW.web_like(90, arrival=8),
               TW.ci_like(70, phase_len=16)]
    r = TSIM.simulate(cfg, tenants, 60, k_max=32, impl=impl, device="cpu")
    got = _collect(r)
    want = json.loads((GOLDEN_DIR / "static_small.json").read_text())
    assert sorted(want) == sorted(got), "telemetry key set drifted"
    for key in sorted(want):
        _diff(got[key], want[key], key)


@functools.lru_cache(maxsize=None)
def _reference_stacked16(mode: str):
    cfg, tenants = JSIM.PRESETS["stacked16"]()
    return JSIM.simulate(cfg, tenants, 60, mode=mode, k_max=128,
                         impl="pallas_ref")


@pytest.mark.parametrize("impl", ["ref", "batched"])
@pytest.mark.parametrize("mode", MODES)
def test_stacked16_matches_reference(mode, impl):
    want = _reference_stacked16(mode)
    got = TSIM.simulate_preset("stacked16", ticks=60, mode=mode, k_max=128,
                               impl=impl, device="cpu")
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(got.migrations, want.migrations)
    assert got.migrations_dropped == want.migrations_dropped
    assert sorted(got.tier_stats) == sorted(want.tier_stats)
    for k, v in want.tier_stats.items():
        np.testing.assert_array_equal(got.tier_stats[k], v, err_msg=k)
    assert got.lower_protection == want.lower_protection
    assert [vars(p) for p in got.pathologies()] == \
        [vars(p) for p in want.pathologies()]
    if mode != "static":
        assert got.promotions.sum() > 0


def test_workload_generators_match_reference():
    makers = [
        lambda W: W.microbenchmark(40, arrival=3, hotness=0.5, ramp=4),
        lambda W: W.thrasher(50, fast_share=12, arrival=2),
        lambda W: W.cache_like(33), lambda W: W.web_like(45, hot_pages=9),
        lambda W: W.ci_like(60, arrival=5, phase_len=12),
        lambda W: W.tao_like(70), lambda W: W.spark_like(52, arrival=1),
        lambda W: W.stream_like(64),
    ]
    got = TW.build_trace([m(TW) for m in makers], 90)
    want = JW.build_trace([m(JW) for m in makers], 90)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tenants_t = TW.stacked_heterogeneous(23)
    tenants_j = JW.stacked_heterogeneous(23)
    assert [vars(w) for w in tenants_t] == [vars(w) for w in tenants_j]
    assert TW.suggest_policy(tenants_t) == JW.suggest_policy(tenants_j)


def test_compare_modes_is_simulate_per_mode():
    cfg, tenants = TSIM.PRESETS["stacked16"]()
    got = TSIM.compare_modes(cfg, tenants, 12, modes=("equilibria", "tpp"),
                             device="cpu")
    assert sorted(got) == ["equilibria", "tpp"]
    for mode, r in got.items():
        want = TSIM.simulate(cfg, tenants, 12, mode=mode, device="cpu")
        assert r.mode == mode
        for f in INT_FIELDS:
            np.testing.assert_array_equal(getattr(r, f), getattr(want, f))
