"""The port's span recorder (``repro_torch/obs/spans.py``) on the CPU: off,
it allocates nothing and records nothing; on, its tree, steps and self
times; under a torch profiler, its ``eq.*`` ranges; the spans that the serve
step, the prefill and a rematerialised train step open; the two timers
repaired beside them (the driver's step clock, the launcher's rate); and
the layer numbers of ``scripts/span_report.py``, on hand-built summaries
and on the benchmark's cells at smoke size.

This file imports neither jax nor the reference package."""
import importlib.util
import pathlib
import threading
import time
import tracemalloc

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TieringConfig, TrainConfig
from repro_torch.ft.driver import FTConfig, TrainDriver
from repro_torch.models import ssm as S
from repro_torch.models.transformer import make_model
from repro_torch.obs import spans
from repro_torch.optim.adamw import init_opt_state
from repro_torch.serve.decode import build_serve_step, init_serve_state
from repro_torch.train.step import make_prefill_step, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE_TREE = {
    ("serve.step", None), ("serve.alloc", "serve.step"),
    ("serve.attention", "serve.step"), ("serve.mamba", "serve.step"),
    ("mamba.state", "serve.mamba"), ("serve.tiering", "serve.step"),
    ("tiering.hotness", "serve.tiering"), ("tiering.quota", "serve.tiering"),
    ("tiering.demote", "serve.tiering"), ("tiering.promote", "serve.tiering"),
    ("tiering.thrash", "serve.tiering")}
TRAIN_TREE = {
    ("train.step", None), ("train.forward", "train.step"),
    ("mamba.block", "train.forward"), ("mamba.scan", "mamba.block"),
    ("train.backward", "train.step"), ("train.optimizer", "train.step"),
    ("train.sync", "train.step")}


@pytest.fixture
def recorder():
    spans.reset()
    spans.enable()
    yield spans
    spans.disable()
    spans.reset()


def tree():
    """The recorded spans as {(name, parent's name)}."""
    recs = spans._REC.records
    return {(r.name, None if r.parent is None else recs[r.parent].name)
            for r in recs}


def test_off_span_is_one_shared_context_that_allocates_nothing():
    spans.reset()
    assert not spans.enabled()
    names = ["serve.step", "mamba.state"] * 500

    def loop(call):
        for n in names:
            call(n)

    def opened(n):
        with spans.span(n):
            pass

    peaks = {}
    for call in (lambda n: None, spans.span, opened):
        loop(call)
        tracemalloc.start()
        try:
            loop(call)
            peaks[call] = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
    empty, called, entered = peaks.values()
    assert called == empty           # span() itself allocates nothing
    assert entered[0] == 0           # nor keeps anything once closed
    assert spans.span("a") is spans.span("b")
    assert spans.summary() == {}


def test_nesting_steps_parents_and_self_time(recorder):
    for _ in range(2):
        with spans.span("serve.step"):
            with spans.span("serve.mamba"):
                with spans.span("mamba.state"):
                    pass
            with spans.span("serve.mamba"):
                pass
    recs = spans._REC.records
    assert [(r.name, r.parent, r.step) for r in recs] == [
        ("serve.step", None, 1), ("serve.mamba", 0, 1),
        ("mamba.state", 1, 1), ("serve.mamba", 0, 1),
        ("serve.step", None, 2), ("serve.mamba", 4, 2),
        ("mamba.state", 5, 2), ("serve.mamba", 4, 2)]
    assert all(r.t0 <= r.t1 for r in recs)
    assert spans.summary()["serve.step"]["device_ms"] is None   # the CPU
    for r, ms in zip(recs, (10.0, 4.0, 1.0, 3.0, 8.0, 2.0, 0.5, 2.0)):
        r.device_ms = ms                 # device times made by hand
    rows = spans.summary()
    step, mamba, state = (rows[n] for n in ("serve.step", "serve.mamba",
                                            "mamba.state"))
    assert (step["steps"], step["calls"]) == (2, 2)
    assert (mamba["steps"], mamba["calls"]) == (2, 4)
    assert step["device_ms"] == 9.0 and step["self_device_ms"] == 3.5
    assert mamba["device_ms"] == 5.5 and mamba["self_device_ms"] == 4.75
    assert state["device_ms"] == state["self_device_ms"] == 0.75
    assert step["host_ms"] >= mamba["host_ms"] >= 0.0


def test_other_threads_and_a_reset_inside_a_span_record_nothing(recorder):
    seen = []
    with spans.span("train.step"):
        t = threading.Thread(target=lambda: seen.append(spans.span("x")))
        t.start()
        t.join()
        with spans.span("train.sync"):
            spans.reset()
    assert seen == [spans._OFF]
    assert spans.summary() == {}
    with spans.span("train.step"):
        pass
    assert spans.summary()["train.step"]["calls"] == 1


def test_profiled_step_opens_ranges_and_stays_out_of_the_summary(recorder):
    with torch.profiler.profile() as prof:
        with spans.span("prefill.step"):
            with spans.span("mamba.block"):
                y = torch.ones(64) * 2
    events = prof.events()
    names = {e.name for e in events}
    assert {"eq.prefill.step", "eq.mamba.block"} <= names
    inside = [e.name for e in events if e.cpu_parent is not None
              and e.cpu_parent.name == "eq.mamba.block"]
    assert "aten::mul" in inside and float(y.sum()) == 128.0
    assert all(r.profiled for r in spans._REC.records)
    assert spans.summary() == {}
    with spans.span("prefill.step"):
        pass
    assert spans.summary()["prefill.step"]["steps"] == 1


def test_hybrid_serve_step_records_the_span_tree(recorder):
    cfg = get_smoke_config("zamba2_7b")
    tcfg = TieringConfig(n_tenants=2, page_tokens=4, thrash_table_slots=64,
                         lower_protection=(2, 2), upper_bound=(0, 3))
    model = make_model(cfg, seed=0, device="cpu")
    state = init_serve_state(cfg, tcfg, 4, 8, device="cpu")
    step = build_serve_step(cfg, tcfg, 4, 8, device="cpu")
    tok = torch.zeros((4, 1), dtype=torch.int32)
    spans.reset()
    for _ in range(3):
        _, state = step(model, state, tok)
    assert tree() == SERVE_TREE
    rows = spans.summary()
    shared = -(-cfg.num_layers // cfg.hybrid_attn_every)
    calls = {n: (r["steps"], r["calls"]) for n, r in rows.items()}
    once = (3, 3)
    assert calls == {
        "serve.step": once, "serve.alloc": once,
        "serve.attention": (3, 3 * shared),
        "serve.mamba": (3, 3 * cfg.num_layers),
        "mamba.state": (3, 3 * cfg.num_layers), "serve.tiering": once,
        "tiering.hotness": once, "tiering.quota": once,
        "tiering.demote": once, "tiering.promote": once,
        "tiering.thrash": once}


def test_prefill_step_opens_the_mamba_spans(recorder):
    cfg = get_smoke_config("zamba2_7b")
    model = make_model(cfg, seed=0, device="cpu")
    step = make_prefill_step(cfg, device="cpu")
    step(model, {"tokens": torch.zeros((1, 16), dtype=torch.int32)})
    assert tree() == {("prefill.step", None),
                      ("mamba.block", "prefill.step"),
                      ("mamba.scan", "mamba.block")}
    rows = spans.summary()
    assert rows["mamba.block"]["calls"] == cfg.num_layers
    assert rows["mamba.scan"]["calls"] == cfg.num_layers


def test_remat_train_step_records_no_span_of_the_backward(recorder,
                                                          monkeypatch,
                                                          tmp_path):
    """With remat "block" the backward re-runs every Mamba2 block's
    forward; those spans are not recorded (``train.backward`` holds that
    work), so each block's span appears once, under ``train.forward``."""
    cfg = get_smoke_config("zamba2_7b")
    blocks = []
    block = S.mamba_block

    def counted(*a, **k):
        blocks.append(torch._C._current_graph_task_id() != -1)
        return block(*a, **k)

    monkeypatch.setattr(S, "mamba_block", counted)
    model = make_model(cfg, seed=0, device="cpu")
    train_step = make_train_step(cfg, TrainConfig(remat_policy="block"),
                                 device="cpu")

    def step_fn(state, batch):
        model, opt = state
        opt, metrics = train_step(model, opt, batch)
        return (model, opt), metrics

    driver = TrainDriver(step_fn, FTConfig(checkpoint_dir=str(tmp_path),
                                           checkpoint_every=1 << 30))
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    spans.reset()
    driver.run((model, init_opt_state(model)),
               iter([{"tokens": tokens, "labels": tokens}]), num_steps=1)
    assert blocks.count(True) == blocks.count(False) == cfg.num_layers
    assert tree() == TRAIN_TREE
    calls = {n: r["calls"] for n, r in spans.summary().items()}
    assert calls == {"train.step": 1, "train.forward": 1,
                     "train.backward": 1, "train.optimizer": 1,
                     "train.sync": 1, "mamba.block": cfg.num_layers,
                     "mamba.scan": cfg.num_layers}


def test_driver_step_time_ignores_wall_clock_jumps(tmp_path, monkeypatch):
    """The driver times a step on a clock that does not jump: a wall clock
    set an hour forward mid-run flags no straggler."""
    wall = [1e9]

    def jumping():
        wall[0] += 3600.0 if len(seen) == 4 else 0.001
        return wall[0]

    seen = []

    def step_fn(s, batch):
        seen.append(batch)
        return {"x": s["x"] + 1}, {}

    monkeypatch.setattr(time, "time", jumping)
    flagged = []
    drv = TrainDriver(step_fn, FTConfig(checkpoint_dir=str(tmp_path),
                                        checkpoint_every=1 << 30),
                      on_straggler=lambda s, dt: flagged.append(s))
    drv.run({"x": torch.zeros(())}, iter(range(10)), num_steps=10)
    assert drv.stats.completed_steps == 10 and flagged == []
    assert drv.stats.step_time_ewma < 1.0


def test_serve_launcher_leaves_its_first_step_out_of_the_rate(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2_130m", "--smoke", "--device", "cpu",
                "--batch", "2", "--steps", "3"])
    line = capsys.readouterr().out.splitlines()[0]
    assert "decoded 3 tokens x 2 seqs" in line and "first step" in line
    assert "tok/s over the 2 steps after the first" in line


def span_report():
    spec = importlib.util.spec_from_file_location(
        "span_report", ROOT / "scripts" / "span_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def row(steps, calls, host, device, self_device=None):
    return {"steps": steps, "calls": calls, "host_ms": host,
            "device_ms": device,
            "self_device_ms": device if self_device is None else self_device}


def test_span_report_layer_numbers_from_a_summary():
    rep = span_report()
    summary = {
        "serve.step": row(4, 4, 140.0, 130.0, 20.0),
        "serve.mamba": row(4, 96, 60.0, 100.0),
        "serve.attention": row(4, 16, 10.0, 4.0),
        "serve.alloc": row(4, 4, 1.0, 0.5),
        "serve.tiering": row(2, 2, 3.0, 6.0),
        "prefill.step": row(2, 2, 1000.0, 990.0),
        "mamba.block": row(2, 48, 700.0, 800.0, 500.0),
        "train.step": row(3, 3, 1200.0, 1190.0),
        "train.sync": row(3, 3, 90.0, 85.0),
        "train.backward": row(3, 3, 500.0, 800.0),
        "train.optimizer": row(3, 3, 20.0, 60.0),
    }
    got = rep.layers(summary)
    assert got == pytest.approx({
        "mamba_ms.decode": 100.0, "attention_ms.decode": 4.0,
        "tiering_ms.decode": 0.5 + 6.0 * 2 / 4,
        "mamba_glue_ms.prefill": 500.0, "backward_ms.train": 800.0,
        "optimizer_ms.train": 60.0,
        "host_enqueue_share.train": 100.0 * (1200.0 - 90.0) / 1200.0})
    assert rep.layers({}) == {}
    cpu = {k: dict(v, device_ms=None, self_device_ms=None)
           for k, v in summary.items()}
    assert set(rep.layers(cpu)) == {"host_enqueue_share.train"}
    del summary["serve.alloc"]
    assert "tiering_ms.decode" not in rep.layers(summary)


def test_span_report_reads_the_host():
    """``host_state`` and ``host_window``: the window's wall time, this
    process's CPU use, the machine's busy, idle and stolen shares summing
    to 1, the cores and threads; and a cell's report carries them."""
    rep = span_report()
    a = rep.host_state()
    sum(i * i for i in range(200_000))
    b = rep.host_state()
    w = rep.host_window(a, b)
    assert w["wall_s"] > 0 and w["process_cores"] >= 0
    assert w["ctx_voluntary_per_s"] >= 0 and w["ctx_involuntary_per_s"] >= 0
    assert w["affinity"] >= 1 and w["torch_threads"] >= 1
    if a["proc_stat"] is not None:
        shares = (w["machine_busy"], w["machine_idle"], w["machine_steal"])
        assert all(0 <= x <= 1 for x in shares)
        assert sum(shares) == pytest.approx(1.0)
    from portbench import smoke
    cell, conf = smoke.smoke_cell("zamba2-decode-tiered")
    out, extra = rep.report("zamba2-decode-tiered", 2**31 + 9, 0.0, False,
                            False, device="cpu", cell=cell, conf=conf)
    assert out["correct"] and extra["host"]["wall_s"] > 0
    assert extra["host"]["affinity"] == w["affinity"]


@pytest.mark.parametrize("name,step", [
    ("zamba2-decode-tiered", "serve.step"),
    ("zamba2-prefill-4k", "prefill.step"),
    ("zamba2-train-4k", "train.step")])
def test_span_report_runs_a_cell_at_smoke_size(name, step):
    rep = span_report()
    from portbench import smoke
    cell, conf = smoke.smoke_cell(name)
    out, extra = rep.report(name, 2**31 + 7, 0.0, False, True,
                            device="cpu", cell=cell, conf=conf)
    assert out["correct"] and not spans.enabled()
    assert extra["summary"][step]["steps"] >= 1
    assert all(r["device_ms"] is None for r in extra["summary"].values())
    assert set(extra["layers"]) <= {"host_enqueue_share.train"}
    assert extra["host_step_ms"] > 0
    out, extra = rep.report(name, 2**31 + 7, 0.0, False, False,
                            device="cpu", cell=cell, conf=conf)
    assert out["correct"] and extra["summary"] == {}
