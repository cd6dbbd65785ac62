"""The port's static-analysis gate (``repro_torch.analysis``) on the CPU,
held against the reference's ``repro.analysis``.

* Live parity with the reference where the reference runs under the
  installed jax: the ``Interval`` algebra, ``dtype_interval`` and
  ``value_interval`` over hypothesis-drawn inputs; the lint keys on the
  reference's own fixture sources; the verdict of each of the ten constancy
  sweeps; purity on every shared tick target; each carried leaf's dtype
  before and after a tick against the reference ``init_state``'s.
* Parity with the reference's committed ``baseline.json``, read as data
  (its overflow pass does not run under jax 0.9.0, ``interval.py:182``):
  the scale point's carry findings, and no carry finding on a small tick
  but the listed expected difference.
* Each fixture flagged by its pass, the clean tick silent, the baseline
  ratchet, the CLI's exit codes, and the interval shadow's storage rules.

The real audit runs once per module on the CPU (``run_audit``; ~25 s,
the L=262,144 scale point included).
"""
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from repro.analysis import interval as RIV
from repro.analysis import lint as RLI
from repro.analysis import fixtures as RFX
from repro.analysis.constancy import check_constant as ref_check_constant
from repro.analysis.findings import Report as RefReport
from repro.analysis.jaxpr_audit import purity_pass as ref_purity_pass

from repro_torch.analysis import __main__ as CLI
from repro_torch.analysis import constancy as C
from repro_torch.analysis import fixtures as FX
from repro_torch.analysis import interval as IV
from repro_torch.analysis import lint as LI
from repro_torch.analysis import targets as TG
from repro_torch.analysis.findings import (BASELINE_PATH, Finding, Report,
                                           load_baseline, write_baseline)
from repro_torch.analysis.op_audit import (capture_pass, donation_pass,
                                           launch_pass, overflow_pass,
                                           steady_memory_pass)
from repro_torch.analysis.walk import KERNELS, named_leaves, record

REF_BASELINE = os.path.join(os.path.dirname(RIV.__file__), "baseline.json")

# Findings of the reference's committed baseline the port's audit does not
# raise, each with why (ROADMAP.md queue 3 logs them with both file:lines).
EXPECTED_MISSING = {
    # the port's shadow keeps the report pages' interval through its stable
    # sort and gather of the constant rowspace (port core/cms.py:134-153),
    # so state.table.page stays in [-1, L-1]; the reference's evaluator
    # saturates the same carry (ref core/cms.py:137-158, its baseline
    # reason: "interval over-approximation")
    "overflow:tick:hotness:neomem:carry:state.table.page",
}

SMALL_TICKS = ([f"tick:static:{m}" for m in ("equilibria", "tpp", "memtis",
                                              "static")]
               + [f"tick:dynamic:{m}" for m in ("equilibria", "tpp",
                                                "memtis", "static")]
               + [f"tick:hotness:{h}" for h in ("sampled", "sketch",
                                                "sketch-sampled", "neomem")])
# the reference's sweep names -> the port's
SWEEPS = {"tick:static:T": "tick:static:T", "tick:dynamic:T": "tick:dynamic:T",
          "tick:dynamic:L": "tick:dynamic:L", "tick:pallas:T": "tick:cuda:T",
          "tick:hotness:sampled:T": "tick:hotness:sampled:T",
          "tick:hotness:sketch:T": "tick:hotness:sketch:T",
          "tick:hotness:neomem:T": "tick:hotness:neomem:T",
          "tick:hotness:sketch:L": "tick:hotness:sketch:L",
          "tick:hotness:sketch-full:L": "tick:hotness:sketch-full:L",
          "tick:hotness:neomem:L": "tick:hotness:neomem:L"}


@pytest.fixture(scope="module")
def audit():
    """The real CPU audit, once: (report, info)."""
    return CLI.run_audit("cpu")


@pytest.fixture(scope="module")
def ref_baseline():
    with open(REF_BASELINE) as fh:
        return json.load(fh)["accepted"]


# ------------------------------------------------- interval algebra parity ----
_bound = st.one_of(st.floats(-1e12, 1e12, allow_nan=False),
                   st.sampled_from([0.0, -1.0, 1.0, float("inf"),
                                    float("-inf")]))


@st.composite
def intervals(draw):
    a, b = draw(_bound), draw(_bound)
    return (min(a, b), max(a, b), draw(st.booleans()))


def _same(x, y) -> bool:
    """Equal tuples, a NaN bound (inf - inf) equal to a NaN bound."""
    return all(a == b or (a != a and b != b) for a, b in zip(x, y))


@settings(max_examples=200, deadline=None)
@given(intervals(), intervals(), st.floats(0, 1e6, allow_nan=False))
def test_interval_algebra_matches_reference(a, b, n):
    pa, pb, ra, rb = IV.Interval(*a), IV.Interval(*b), RIV.Interval(*a), \
        RIV.Interval(*b)
    for pf, rf in ((IV.add_iv, RIV.add_iv), (IV.sub_iv, RIV.sub_iv),
                   (IV.mul_iv, RIV.mul_iv)):
        assert _same(pf(pa, pb), rf(ra, rb))
    assert _same(IV.scale_iv(pa, n), RIV.scale_iv(ra, n))
    assert _same(pa.union(pb), ra.union(rb))
    assert pa.contains(pb) == ra.contains(rb)
    assert pa.bounded() == ra.bounded()


@pytest.mark.parametrize("tdt,jdt", [
    (torch.bool, jnp.bool_), (torch.int8, jnp.int8), (torch.int16, jnp.int16),
    (torch.int32, jnp.int32), (torch.int64, jnp.int64),
    (torch.uint8, jnp.uint8), (torch.float16, jnp.float16),
    (torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
    (torch.float64, jnp.float64)])
def test_dtype_interval_matches_reference(tdt, jdt):
    assert tuple(IV.dtype_interval(tdt)) == tuple(RIV.dtype_interval(jdt))


_arrays = st.one_of(
    st.lists(st.integers(-2**31, 2**31 - 1), min_size=1, max_size=16).map(
        lambda v: np.asarray(v, np.int32)),
    st.lists(st.booleans(), min_size=1, max_size=16).map(
        lambda v: np.asarray(v, bool)),
    st.lists(st.floats(-1e6, 1e6, allow_nan=False, width=32), min_size=1,
             max_size=16).map(lambda v: np.asarray(v, np.float32)),
    st.lists(st.integers(-2**20, 2**20), min_size=1, max_size=16).map(
        lambda v: np.asarray(v, np.float32)))


@settings(max_examples=150, deadline=None)
@given(_arrays)
def test_value_interval_matches_reference(arr):
    assert tuple(IV.value_interval(torch.from_numpy(arr))) == \
        tuple(RIV.value_interval(arr))


# --------------------------------------------------------- lint parity ----
@pytest.mark.parametrize("name", ["BAD_LINT_TENANT_LOOP",
                                  "BAD_LINT_NP_IN_GRAPH",
                                  "BAD_LINT_SEAM_DEFAULT", "CLEAN_LINT"])
@pytest.mark.parametrize("in_core", [True, False])
def test_lint_keys_match_reference_on_its_fixtures(name, in_core):
    src = getattr(RFX, name)
    want = sorted(f.key for f in RLI.lint_source(src, "fx", in_core=in_core))
    got = sorted(f.key for f in LI.lint_source(src, "fx", in_core=in_core))
    assert got == want


def test_lint_flags_host_reads_in_tick_closures():
    keys = {f.slug for f in LI.lint_source(FX.BAD_LINT_NP_IN_GRAPH, "fx")}
    assert keys == {"np-in-graph:make_tick.tick",
                    "np-in-graph:make_tick.tick#1"}
    # the same calls at builder level run once, not per tick
    assert not LI.lint_source(
        "def make_tick(x):\n    n = x.item()\n    return n\n", "fx")


# ----------------------------------------------------- constancy parity ----
@pytest.fixture(scope="module")
def ref_sweeps():
    from repro.analysis.targets import tick_constancy_sweeps
    return tick_constancy_sweeps()


@pytest.mark.parametrize("ref_name", sorted(SWEEPS))
def test_constancy_verdict_matches_reference(ref_name, audit, ref_sweeps):
    build, params = ref_sweeps[ref_name]
    ref_ok, _sig, _diff = ref_check_constant(build, params)
    sigs = audit[1]["constancy"][SWEEPS[ref_name]]
    port_ok = all(s == sigs[0][1] for _p, s in sigs)
    assert port_ok == ref_ok is True
    assert [p for p, _s in sigs] == list(params)


def test_constancy_checker_and_diff():
    sig = C.assert_op_constant(FX.good_constancy_build, (2, 5))
    assert isinstance(sig, C.OpSignature) and sig.n_ops > 0
    with pytest.raises(AssertionError) as ei:
        C.assert_op_constant(FX.bad_constancy_build, (2, 5), label="bad")
    assert "[bad]" in str(ei.value) and "op count" in str(ei.value)
    ok, _base, diff = C.check_constant(FX.bad_constancy_build, (2, 5))
    assert not ok and diff


def test_signature_counts_kernel_launches():
    a = C.OpSignature(3, (("add.Tensor", 3),), (("seg_topk", 1),))
    b = a._replace(launches=(("seg_topk", 2),))
    assert a != b and a.diff(b) == ["  launches seg_topk: 1 -> 2"]


# -------------------------------------------------------- purity parity ----
def test_purity_matches_reference_on_every_shared_tick(audit):
    from repro.analysis.targets import all_targets
    ref = RefReport()
    for t in all_targets(scale=False, fleet=False):
        if t.name.startswith("tick:"):
            ref_purity_pass(t.closed, t.name, ref)
    report, info = audit
    port = [f for f in report.findings if f.pass_name == "purity"]
    assert set(SMALL_TICKS) <= set(info["targets"])
    assert ref.findings == [] and port == []


def test_record_sees_host_reads_and_charges_port_frames():
    t = FX.bad_purity()
    tr = record(t.fn, *t.phases[0])
    reads = [op for op in tr.ops if op.host_read]
    assert [op.name for op in reads] == ["_local_scalar_dense.default"]
    assert reads[0].where == "analysis/fixtures.py:bad_purity.tick"
    assert set(tr.launches) == {name for _tag, _mod, name in KERNELS}


# ------------------------------------------------ carried dtype parity ----
def _ref_leaf_dtypes(hotness, owner, L, cfg_kw):
    import jax
    from repro.configs.base import TieringConfig as RefCfg
    from repro.core.state import init_state as ref_init_state
    cfg = RefCfg(**cfg_kw)
    state = ref_init_state(cfg, L, owner=owner, hotness=hotness)
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {f"state{jax.tree_util.keystr(p)}": np.dtype(x.dtype).name
            for p, x in flat}


@pytest.mark.parametrize("kind,hotness", [("static", None),
                                          ("static", "sketch"),
                                          ("static", "neomem"),
                                          ("dynamic", None)])
def test_carried_leaf_dtypes_match_reference(kind, hotness):
    T, pages_per, L = 3, 16, 48
    fast = T * pages_per // 2
    cfg_kw = dict(n_tenants=T, n_fast_pages=fast, n_slow_pages=T * pages_per,
                  lower_protection=(fast // (2 * T),) * T,
                  upper_bound=(fast,) * T)
    if kind == "static":
        t = TG.static_tick_target("equilibria", hotness=hotness,
                                  device="cpu")
        owner = np.repeat(np.arange(T), pages_per)
    else:
        t = TG.dynamic_tick_target("equilibria", L=L, device="cpu")
        cfg_kw.update(n_fast_pages=L // 2, n_slow_pages=L // 2,
                      lower_protection=(L // 2 // (2 * T),) * T,
                      upper_bound=(L // 2,) * T)
        owner = None
    want = _ref_leaf_dtypes(hotness, owner, L, cfg_kw)
    state, inputs = t.phases[0]
    after, _out = t.fn(state, inputs)
    before = {n: str(x.dtype).removeprefix("torch.")
              for n, x in named_leaves(state, "state")}
    after = {n: str(x.dtype).removeprefix("torch.")
             for n, x in named_leaves(after, "state")}
    shared = set(before) & set(want)
    # every port leaf has its reference counterpart (the reference also
    # carries the tick counter ``state.t``, a host int in the port)
    assert set(before) <= set(want) and set(want) - shared == {"state.t"}
    for name in shared:
        assert before[name] == after[name] == want[name], name


# ------------------------------------------ baseline parity (reference) ----
def _carry_keys(report, target):
    return {f.key for f in report.findings
            if f.target == target and f.slug.startswith("carry:")}


def test_scale_carries_match_reference_baseline(audit, ref_baseline):
    want = {k for k in ref_baseline
            if k.startswith("overflow:tick:scale:carry:")}
    assert len(want) == 15
    assert _carry_keys(audit[0], "tick:scale") == want


def test_small_ticks_carry_findings_match_reference_baseline(audit,
                                                             ref_baseline):
    for target in SMALL_TICKS:
        want = {k for k in ref_baseline
                if k.startswith(f"overflow:{target}:carry:")}
        got = _carry_keys(audit[0], target)
        assert got == want - EXPECTED_MISSING, target
    assert EXPECTED_MISSING <= set(ref_baseline)


# ------------------------------------------------ the port's own gate ----
def test_gate_passes_and_every_baseline_key_has_a_reason(audit):
    with open(BASELINE_PATH) as fh:
        data = json.load(fh)
    assert data["accepted"] and all(data["reasons"].get(k)
                                    for k in data["accepted"])
    report, _info = audit
    assert report.new_vs(load_baseline()) == []


def test_cli_gate_exit_codes(audit, monkeypatch, capsys):
    monkeypatch.setattr(CLI, "run_audit", lambda *a, **k: audit)
    assert CLI.main(["--device", "cpu", "--gate"]) == 0
    assert "0 new" in capsys.readouterr().out


@pytest.mark.parametrize("fixture", ["purity", "dtype", "overflow",
                                     "constancy", "donation", "lint"])
def test_cli_gate_fails_each_bad_fixture(fixture, capsys):
    assert CLI.main(["--device", "cpu", "--fixture", fixture, "--gate"]) == 1
    assert "GATE" in capsys.readouterr().err


def test_cli_gate_passes_clean_fixture(capsys):
    assert CLI.main(["--device", "cpu", "--fixture", "clean", "--gate"]) == 0
    assert "(0 new" in capsys.readouterr().out


@pytest.mark.parametrize("fixture", ["purity", "dtype", "overflow",
                                     "constancy", "donation", "lint"])
def test_each_fixture_is_flagged_by_its_pass(fixture):
    report = Report()
    assert CLI._run_fixture(fixture, report, "cpu") == []
    assert report.findings
    assert {f.pass_name for f in report.findings} == {fixture}


def test_clean_tick_is_silent_but_for_the_real_ticks_baseline():
    report = Report()
    held = CLI._run_fixture("clean", report, "cpu")
    assert report.new_vs(held) == []
    # what it is held to: the real tick's deliberate float64 sites and
    # hotness bit-casts, nothing of its own
    assert all(k.startswith(("dtype:fixture:clean:float64@",
                             "overflow:fixture:clean:cast-int32@"))
               for k in report.keys())


def test_overflow_pass_flags_carry_only_past_its_horizon():
    t = FX.bad_overflow_carry()
    bad, ok = Report(), Report()
    overflow_pass(t.fn, t.phases, t.names, "fx", bad, t.input_ivals,
                  t.carry, t.horizon)
    overflow_pass(t.fn, t.phases, t.names, "fx", ok, t.input_ivals,
                  t.carry, 100)
    assert [f.slug for f in bad.findings] == ["carry:counter"]
    assert ok.findings == []


def test_overflow_pass_ignores_transient_carry_jump():
    """A carry that jumps once and then holds (tier -1 -> 1) is not
    extrapolated as a per-tick growth rate."""
    def tick(tier, hot):
        new = torch.where(hot > 0, torch.ones_like(tier), tier)
        return new, new.sum(dtype=torch.int32)
    report = Report()
    overflow_pass(tick, [(torch.full((8,), -1, dtype=torch.int8),
                          torch.zeros((8,), dtype=torch.int32))],
                  ("tier", "hot"), "fx", report,
                  {"hot": IV.Interval(0, 5, True)}, (0, 0), 100_000)
    assert report.findings == []


def test_donation_passes():
    bad, good = Report(), Report()
    donation_pass(*FX.bad_donation(), "fx", bad)
    donation_pass(*FX.good_donation(), "fx", good)
    assert [f.slug for f in bad.findings] == ["unmatched:arg0:leaf0"]
    assert good.findings == []
    grow, flat = Report(), Report()
    steady_memory_pass(lambda s: torch.cat([s, s[:1]]), torch.zeros(4), 4,
                       "fx", grow)
    steady_memory_pass(lambda s: s + 1, torch.zeros(4), 4, "fx", flat)
    # a state that settles smaller (leaves coming to share a storage) does
    # not grow
    steady_memory_pass(lambda s: s[:2] + 1, torch.zeros(4), 4, "fx", flat)
    assert [f.slug for f in grow.findings] == ["growth:state-bytes"]
    assert flat.findings == []


def test_launch_and_capture_findings():
    t = TG.kernel_targets("cpu")[0]
    tr = record(t.fn, *t.phases[0])
    report = Report()
    launch_pass(tr, t.kernel, t.name, report)        # plain version: no launch
    capture_pass({"phases": [{"phase": "tick", "ok": True}]}, "x", report)
    capture_pass({"phases": [
        {"phase": "tick", "ok": True},
        {"phase": "controller", "ok": False, "where": "core/tick.py:f",
         "error": "e"}]}, "x", report)
    assert report.keys() == ["launch:kernel:flash_attention:"
                             "no-launch:flash_attention",
                             "purity:x:capture:controller@core/tick.py:f"]


def test_baseline_ratchet_keeps_the_other_devices_keys(tmp_path):
    rep = Report(audited={"t"})
    rep.add(Finding("dtype", "t", "a", "m"))
    rep.add(Finding("dtype", "t", "b", "m"))
    path = str(tmp_path / "baseline.json")
    write_baseline(rep, path, reasons={"dtype:t:a": "known"})
    with open(path) as fh:
        data = json.load(fh)
    data["accepted"].append("purity:tick:cuda:equilibria:capture@x")
    with open(path, "w") as fh:
        json.dump(data, fh)
    nxt = Report(audited={"t"})
    nxt.add(Finding("dtype", "t", "a", "m"))
    nxt.add(Finding("dtype", "t", "c", "m"))
    assert [f.key for f in nxt.new_vs(data["accepted"])] == ["dtype:t:c"]
    # the card-only target was not audited here: neither stale nor dropped
    assert nxt.stale_vs(data["accepted"]) == ["dtype:t:b"]
    write_baseline(nxt, path)
    with open(path) as fh:
        again = json.load(fh)
    assert again["accepted"] == ["dtype:t:a", "dtype:t:c",
                                 "purity:tick:cuda:equilibria:capture@x"]
    assert again["reasons"]["dtype:t:a"] == "known"


def test_card_only_keys_are_neither_stale_nor_dropped_on_the_cpu(tmp_path):
    keys = ["dtype:kernel:ssd_scan:float64@kernels/ssd_scan/kernel.py:"
            "ssd_scan_cuda", "purity:tick:x:sync@core/cms.py:cms_clear",
            "launch:kernel:seg_sums:no-launch:seg_sums"]
    cpu = Report(audited={"kernel:ssd_scan", "tick:x", "kernel:seg_sums"},
                 device="cpu")
    assert cpu.stale_vs(keys) == []
    card = Report(audited=cpu.audited)
    assert card.stale_vs(keys) == sorted(keys)
    path = str(tmp_path / "baseline.json")
    with open(path, "w") as fh:
        json.dump({"accepted": keys, "reasons": {}}, fh)
    write_baseline(cpu, path)
    assert load_baseline(path) == sorted(keys)


# ------------------------------------------------- the interval shadow ----
def _shadowed(fn, *args, seeds=()):
    shadow = IV.IntervalShadow()
    for t, iv in seeds:
        shadow.seed(t, iv)
    tr = record(fn, *args, shadow=shadow)
    return shadow, tr


def test_in_place_write_through_a_view_widens_its_base():
    base = torch.zeros(8, dtype=torch.int32)

    def f(x):
        x[2:4].add_(5)                      # a view's in-place add
        y = torch.zeros(8, dtype=torch.int32)
        y.index_add_(0, torch.tensor([1, 1, 1]),
                     torch.ones(3, dtype=torch.int32))
        return x, y
    shadow, tr = _shadowed(f, base, seeds=[(base, IV.Interval(0, 1, True))])
    x, y = tr.result
    assert shadow.iv(x) == IV.Interval(0, 6, True)
    assert shadow.iv(y) == IV.Interval(0, 3, True)
    # a constant first met through a partial in-place write keeps its rest
    const = torch.arange(8, dtype=torch.int32)
    shadow, _tr = _shadowed(lambda: const[2:4].copy_(torch.full((2,), 100)))
    assert shadow.iv(const) == IV.Interval(0, 100, True)


def test_slices_of_one_constant_share_its_whole_range():
    # a table built outside the call, its rows with disjoint ranges: the
    # first row read must not fix the storage's interval to its own
    table = torch.tensor([[0, 1], [100, 200]], dtype=torch.int32)
    shadow, tr = _shadowed(lambda: (table[0] + 0, table[1] + 0))
    lo, hi = tr.result
    assert shadow.iv(lo).contains(IV.Interval(0, 1, True))
    assert shadow.iv(hi).contains(IV.Interval(100, 200, True))
    assert shadow.iv(table[1]) == IV.Interval(0, 200, True)


def test_casts_and_bitcasts_raise_events():
    def f(x):
        big = x.sum(dtype=torch.int32)
        return (big.to(torch.float32), x.to(torch.int8),
                x.to(torch.float32).view(torch.int32))
    x = torch.zeros(4096, dtype=torch.int32)
    shadow, tr = _shadowed(f, x, seeds=[(x, IV.Interval(0, 10_000, True))])
    kinds = {e.kind for e in shadow.ctx.events}
    assert kinds == {"cast-precision", "cast-truncate", "bitcast"}
    assert shadow.iv(tr.result[2]) == IV.dtype_interval(torch.int32)
    # no frame of the port issued these ops
    assert {e.where for e in shadow.ctx.events} == {"<top>"}


def test_unmodelled_ops_widen_and_are_noted():
    x = torch.ones(4)
    shadow, tr = _shadowed(lambda v: torch.special.entr(v), x)
    assert shadow.iv(tr.result) == IV.TOP_F
    assert shadow.ctx.unknown_ops == {"special_entr": 1}
