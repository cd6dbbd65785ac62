"""The port's telemetry exporters (``obs/export.py``), dashboard
(``obs/dashboard.py``) and ``serve_exposition`` held against the JAX
reference (CPU, small sizes): for the same inputs the text is identical to
the reference's, and the reference's validators accept it.
"""
import dataclasses
import functools
import json
import types

import numpy as np
import pytest
import torch

from repro.core.state import Counters as JCounters
from repro.obs import dashboard as JDB
from repro.obs import export as JEX
from repro.obs.trace import MigrationRing as JRing
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.models.transformer import make_model
from repro_torch.obs import dashboard as TDB
from repro_torch.obs import export as TEX
from repro_torch.obs import trace as TOT
from repro_torch.serve.decode import (build_serve_step, init_serve_state,
                                      serve_exposition)


@functools.lru_cache(maxsize=None)
def _demo(side):
    """The dashboard's noisy demo fleet, 2 hosts x 80 ticks."""
    if side == "ref":
        return JDB.demo_fleet(hosts=2, ticks=80, chunk=40, noisy=True)
    return TDB.demo_fleet(hosts=2, ticks=80, chunk=40, noisy=True,
                          device="cpu")


def _events(seed, n=60, T=3):
    """Seeded decoded-ring events: promote/demote pairs, lone demotes and
    promotes left open, over a few tenants and pages."""
    rng = np.random.default_rng(seed)
    ev = np.empty(n, TOT.EVENT_DTYPE)
    ev["tick"] = np.sort(rng.integers(0, 40, n))
    ev["tenant"] = rng.integers(0, T, n)
    ev["page"] = rng.integers(0, 12, n)
    ev["direction"] = rng.integers(0, 2, n)
    ev["hotness"] = rng.random(n).astype(np.float32) * 8
    return ev


# ---------------------------------------------------------- chrome trace ----
@pytest.mark.parametrize("horizon", [None, 50])
@pytest.mark.parametrize("seed", range(3))
def test_chrome_trace_is_identical(seed, horizon):
    events = {h: _events(seed * 7 + h) for h in range(3)}
    events[3] = _events(0, n=0)
    got = TEX.chrome_trace(events, t_resident=6, horizon=horizon)
    want = JEX.chrome_trace(events, t_resident=6, horizon=horizon)
    assert json.dumps(got) == json.dumps(want)
    assert JEX.validate_chrome_trace(got) == \
        TEX.validate_chrome_trace(json.dumps(got)) > 0


def test_demo_fleet_trace_and_exposition_are_identical(tmp_path):
    (_, got), (_, want) = _demo("port"), _demo("ref")
    ev_t = {h: got.host_migrations(h)[0] for h in range(2)}
    ev_j = {h: want.host_migrations(h)[0] for h in range(2)}
    for h in ev_t:
        for f in TOT.EVENT_DTYPE.names:
            np.testing.assert_array_equal(ev_t[h][f], ev_j[h][f])
    path = tmp_path / "t.json"
    trace = TEX.write_chrome_trace(str(path), ev_t, t_resident=8, horizon=80)
    assert path.read_text() == json.dumps(JEX.chrome_trace(
        ev_j, t_resident=8, horizon=80))
    assert JEX.validate_chrome_trace(path.read_text()) == \
        TEX.validate_chrome_trace(trace)
    text = TEX.rollout_exposition(got)
    assert text == JEX.rollout_exposition(want)
    assert JEX.validate_exposition(text) == TEX.validate_exposition(text) > 0
    for family in ("equilibria_stall_component_total",
                   "equilibria_stall_units_per_tick_bucket",
                   "equilibria_pathology_flag_ticks_total",
                   "equilibria_ring_dropped_total"):
        assert family in text


# ---------------------------------------------------------- exposition ----
def _fleet_inputs(seed, H=2, T=3):
    rng = np.random.default_rng(seed)
    counters = {k: rng.integers(0, 2**40, (H, T)) for k in
                ("promotions", "demotions", "thrash_events")}
    first = rng.integers(-1, 90, (H, T, 4)).astype(np.int32)
    return dict(
        counters=counters,
        resid_hist=rng.integers(0, 9, (H, T, 8)).astype(np.int32),
        flag_ticks=rng.integers(0, 40, (H, T, 4)).astype(np.int32),
        first_flag=first,
        stall_components=rng.integers(0, 500, (H, T, 5)),
        stall_totals=rng.integers(0, 2500, (H, T)),
        stall_sketch=rng.integers(0, 30, 164).astype(np.int32),
        ring_events=rng.integers(0, 9000, H),
        ring_dropped=rng.integers(0, 900, H))


@pytest.mark.parametrize("prefix", ["equilibria", "fleet_a"])
@pytest.mark.parametrize("seed", range(3))
def test_fleet_exposition_is_identical(seed, prefix):
    kw = _fleet_inputs(seed)
    want = JEX.fleet_exposition(prefix=prefix, **kw)
    got = TEX.fleet_exposition(prefix=prefix, **kw)
    assert got == want
    # tensors are read the same as arrays
    tk = {k: ({m: torch.as_tensor(v) for m, v in a.items()}
              if isinstance(a, dict) else torch.as_tensor(a))
          for k, a in kw.items()}
    assert TEX.fleet_exposition(prefix=prefix, **tk) == want
    assert JEX.validate_exposition(got) == TEX.validate_exposition(got) > 0


BAD_TEXTS = [
    'm_total 1\n',
    '# TYPE m_total counter\n# TYPE m_total counter\nm_total 1\n',
    '# HELP m_total T.\n# TYPE m_total counter\nm_total{host="a\\qb"} 1\n',
    '# HELP h T.\n# TYPE h histogram\nh_bucket{le="1"} 5\n'
    'h_bucket{le="2"} 3\nh_bucket{le="+Inf"} 5\nh_count 5\n',
    '# HELP h T.\n# TYPE h histogram\nh_bucket{le="1"} 5\nh_count 5\n',
    '# HELP h T.\n# TYPE h histogram\nh_bucket{le="+Inf"} 6\nh_count 7\n',
    '# BAD\n',
]


@pytest.mark.parametrize("text", BAD_TEXTS)
def test_validators_reject_as_the_reference_does(text):
    with pytest.raises(ValueError) as want:
        JEX.validate_exposition(text)
    with pytest.raises(ValueError) as got:
        TEX.validate_exposition(text)
    assert str(got.value) == str(want.value)
    bad = {"traceEvents": [{"ph": "X", "ts": 5, "pid": 0, "tid": 0,
                            "name": "a", "dur": 1},
                           {"ph": "E", "ts": 6, "pid": 0, "tid": 0,
                            "name": "a"}]}
    with pytest.raises(ValueError, match="no open 'B'"):
        TEX.validate_chrome_trace(bad)


# ------------------------------------------------------------ dashboard ----
def test_dashboard_matches_reference_and_cli(tmp_path, capsys):
    (_, got), (_, want) = _demo("port"), _demo("ref")
    md_t = TDB.render_dashboard(got).splitlines()
    md_j = JDB.render_dashboard(want).splitlines()
    # the overview row's host-ticks/s is a wall-clock reading
    assert [ln for i, ln in enumerate(md_t) if i != 4] == \
        [ln for i, ln in enumerate(md_j) if i != 4]
    assert md_t[4].split("|")[1:3] == md_j[4].split("|")[1:3]
    trace, prom = tmp_path / "f.json", tmp_path / "f.prom"
    assert TDB.main(["--hosts", "2", "--ticks", "40", "--noisy", "--device",
                     "cpu", "--trace", str(trace), "--prom",
                     str(prom)]) == 0
    out = capsys.readouterr().out
    assert "## Slowdown attribution" in out and "(validated)" in out
    assert JEX.validate_chrome_trace(trace.read_text()) > 0
    assert JEX.validate_exposition(prom.read_text()) > 0


# -------------------------------------------------------------- serving ----
def test_serve_exposition_on_smoke_llama():
    """The serving counters of a ported Llama smoke cache after 16 decode
    steps (bounds of 3 pages force moves), exported by the port and by the
    reference's ``kv_exposition`` over the same numbers."""
    cfg = dataclasses.replace(t_smoke("llama32_1b"), dtype="float32",
                              param_dtype="float32")
    tcfg = TCfg(n_tenants=2, page_tokens=4, thrash_table_slots=64,
                lower_protection=(2, 2), upper_bound=(3, 3))
    B, steps = 4, 16
    model = make_model(cfg, seed=0, device="cpu")
    step = build_serve_step(cfg, tcfg, B, steps, device="cpu")
    state = init_serve_state(cfg, tcfg, B, steps, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, steps)))
    with torch.no_grad():
        for i in range(steps):
            _, state = step(model, state, toks[:, i:i + 1])
    kv = state["kv"]
    assert int(kv.counters.promotions.sum() + kv.counters.demotions.sum()) > 0
    text = serve_exposition(state)
    ref_cache = types.SimpleNamespace(
        counters=JCounters(**{k: v.numpy() for k, v in
                              kv.counters._asdict().items()}),
        ring=JRing(data=kv.ring.data.numpy(), head=kv.ring.head.numpy()))
    assert text == JEX.kv_exposition(ref_cache)
    assert JEX.validate_exposition(text) > 0
    assert "equilibria_kv_promotions_total" in text
    assert serve_exposition(state, prefix="kv2").startswith("# HELP kv2_")
    with pytest.raises(ValueError, match="no tiered KV cache"):
        serve_exposition({"mamba": None})
