"""Ground rules of the port that hold on any machine.

* Nothing under ``src/repro_torch/``, nor ``chip_smoke.py``, imports
  ``jax`` or the reference package ``repro`` (checked on the AST, so a
  lazy import inside a function counts too).
* Every module of the port imports on a machine without a card (kernels
  are built and ``triton``/``nvcc`` reached only inside the launching call).
* No silent CPU fallback: the entry points and every public constructor
  default to ``device="cuda"`` and raise when no card is present;
  ``impl="cuda"`` on the CPU raises; a kernel wrapper handed a CPU tensor
  runs the plain version only because the tensor lies on the CPU.
"""
import ast
import dataclasses
import importlib
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core import engine, simulator
from repro_torch.core.workloads import microbenchmark

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"]
PORT_MODULES = sorted(
    ".".join(("repro_torch",) + p.relative_to(PORT_DIR).with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT_DIR.rglob("*.py"))
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", PORT_MODULES)
def test_every_port_module_imports_without_a_card(module):
    importlib.import_module(module)


def test_import_scan_sees_lazy_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    from repro.core import tick\n"
                 "    import jax.numpy as jnp\n")
    assert {"repro", "jax"} <= set(_imported_roots(f))


def _tiny():
    cfg = TieringConfig(n_tenants=1, n_fast_pages=16, n_slow_pages=32)
    return cfg, [microbenchmark(24)]


@pytest.fixture
def no_card(monkeypatch):
    """Pretend the machine has no CUDA device (true on the CPU runners)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_simulate_without_device_raises(no_card):
    cfg, tenants = _tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        simulator.simulate(cfg, tenants, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        simulator.simulate_preset("stacked16", ticks=2)


def test_engine_entry_points_without_device_raise(no_card):
    cfg, _ = _tiny()
    owner = np.zeros(24, np.int32)
    acc = np.ones((2, 24), np.float32)
    alive = np.ones((2, 24), bool)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.make_tick(cfg, owner)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.run_engine(cfg, owner, acc, alive)


def test_churn_entry_points_without_device_raise(no_card):
    from repro_torch.core import churn
    from repro_torch.core.workloads import ChurnSlot
    cfg, tenants = _tiny()
    sched = churn.ChurnSchedule(np.full((2, 1), 8, np.int32),
                                np.ones((2, 1, 8), np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        simulator.simulate_churn(cfg, [ChurnSlot(tenants[0], [(0, 3)])], 3)
    with pytest.raises(RuntimeError, match="cuda"):
        simulator.simulate_preset("churn16", ticks=2)
    with pytest.raises(RuntimeError, match="cuda"):
        churn.run_churn_engine(cfg, sched)
    with pytest.raises(RuntimeError, match="cuda"):
        churn.make_churn_tick(cfg, 48)


def test_cuda_impl_on_cpu_raises():
    cfg, tenants = _tiny()
    with pytest.raises(ValueError, match="impl='cuda'"):
        simulator.simulate(cfg, tenants, 3, impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="impl"):
        simulator.simulate(cfg, tenants, 3, impl="pallas", device="cpu")


def test_cpu_runs_only_when_asked():
    cfg, tenants = _tiny()
    r = simulator.simulate(cfg, tenants, 3, device="cpu")
    assert r.fast_usage.shape == (3, 1)
    assert engine.resolve_impl(None, torch.device("cpu")) == "ref"
    assert engine.resolve_impl(None, torch.device("cuda")) == "cuda"


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    from repro_torch.kernels.migrate import ops as KMIG
    from repro_torch.kernels.select import ops as KSEL
    before = (KSEL.seg_topk.launches, KSEL.seg_reduce.launches,
              KSEL.seg_sums.launches, KMIG.commit_moves.launches)
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    v = torch.ones((3, 4), dtype=torch.bool)
    KSEL.seg_topk(x.float(), v, torch.full((3,), 2, dtype=torch.int32), 2)
    KSEL.seg_reduce(x, v)
    assert KSEL.seg_sums(x, v).tolist() == [6, 22, 38]
    KMIG.commit_moves(torch.zeros(4, dtype=torch.int32),
                      torch.zeros((2, 5), dtype=torch.int32),
                      torch.zeros((), dtype=torch.int32),
                      torch.tensor([1], dtype=torch.int32),
                      torch.tensor([True]), torch.tensor([0]),
                      torch.tensor([0.5]), 0, direction=0, to_tier=0)
    assert (KSEL.seg_topk.launches, KSEL.seg_reduce.launches,
            KSEL.seg_sums.launches, KMIG.commit_moves.launches) == before


def _constructors(**dev):
    """Every public constructor and entry point of the port, called with
    valid arguments and ``dev`` (empty: no ``device`` argument)."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (churn, cms, hotness, select, state, tick,
                                  workloads)
    from repro_torch.launch import serve as launch_serve
    from repro_torch.memtier import kvcache
    from repro_torch.models import ssm
    from repro_torch.models.transformer import (DenseLM, HybridLM, MoELM,
                                                SSMLM, make_model)
    from repro_torch.obs import (attribution, counterfactual, dashboard,
                                 fleet, sketch, stats, streaming, trace)
    from repro_torch.serve import decode
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.train.step import make_prefill_step, make_train_step
    from repro_torch.analysis.__main__ import main as analysis_main
    cfg = TieringConfig(n_tenants=2, n_fast_pages=8, n_slow_pages=16,
                        page_tokens=4)
    owner = np.repeat(np.arange(2, dtype=np.int32), 4)
    mcfg = get_smoke_config("llama32_1b")
    hcfg = get_smoke_config("zamba2_7b")
    ecfg = get_smoke_config("granite_moe_3b_a800m")
    scfg = get_smoke_config("mamba2_130m")

    def param_tree(model_cfg=mcfg):
        tree: dict = {}
        for name, p in make_model(model_cfg, device="cpu"
                                  ).named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = p.numpy()
        return tree

    cli = ["--smoke", "--batch", "2", "--steps", "4"] + (
        ["--device", dev["device"]] if dev else [])
    det = streaming.make_detector(4, 2)
    att = attribution.make_attribution(2)
    slots = [workloads.ChurnSlot(workloads.microbenchmark(6), [(0, 3)]),
             workloads.ChurnSlot(workloads.web_like(8), [(1, 4)])]
    sched = workloads.build_churn_schedule(slots, 4)
    signals = {f: np.ones((4, 2), bool if f == "active" else np.int32)
               for f in streaming.DetectorSignals._fields}
    return {
        "init_detector": lambda: streaming.init_detector(det, **dev),
        "run_detector": lambda: streaming.run_detector(det, **signals,
                                                       **dev),
        "init_attribution": lambda: attribution.init_attribution(att,
                                                                 **dev),
        "init_sketch": lambda: sketch.init_sketch((2,), **dev),
        "init_state[seams]": lambda: state.init_state(
            cfg, 8, owner, detector=det, attrib=att, **dev),
        "run_fleet": lambda: fleet.run_fleet(
            cfg, [[workloads.microbenchmark(4), workloads.web_like(4)]] * 2,
            3, k_max=4, **dev),
        "run_mixed_fleet": lambda: fleet.run_mixed_fleet(
            cfg, [slots, slots], 4, k_max=4, **dev),
        "fleet_rollout": lambda: fleet.fleet_rollout(
            cfg, sched.want[None], sched.rates[None], 4, k_max=4, chunk=3,
            **dev),
        "counterfactual_run": lambda: counterfactual.counterfactual_run(
            cfg, sched, k_max=4, **dev),
        "demo_fleet": lambda: dashboard.demo_fleet(hosts=1, ticks=4,
                                                   chunk=2, **dev),
        "dashboard.main": lambda: dashboard.main(
            ["--hosts", "1", "--ticks", "4"]
            + (["--device", dev["device"]] if dev else [])),
        "zero_counters": lambda: state.zero_counters(2, **dev),
        "init_state": lambda: state.init_state(cfg, 8, owner, **dev),
        "make_policy": lambda: state.make_policy(cfg, **dev),
        "init_ring": lambda: trace.init_ring(16, **dev),
        "init_stats": lambda: stats.init_stats(2, (8,), **dev),
        "plan_layout": lambda: select.plan_layout(owner, 2, **dev),
        "static_strategy": lambda: select.static_strategy(owner, 2, 4,
                                                          **dev),
        "static_rowspace": lambda: hotness.static_rowspace(owner, 2, **dev),
        "static_ownership": lambda: tick.static_ownership(cfg, owner, 4,
                                                          **dev),
        "dynamic_strategy": lambda: select.dynamic_strategy(2, 4, **dev),
        "kernel_dynamic_strategy": lambda: select.kernel_dynamic_strategy(
            2, 4, impl="ref", **dev),
        "dynamic_ownership": lambda: tick.dynamic_ownership(cfg, 24, 4,
                                                            **dev),
        "make_churn_tick": lambda: churn.make_churn_tick(cfg, 24, **dev),
        "run_churn_engine": lambda: churn.run_churn_engine(
            cfg, churn.ChurnSchedule(np.full((2, 2), 4, np.int32),
                                     np.ones((2, 2, 4), np.float32)), **dev),
        "simulate_churn": lambda: simulator.simulate_churn(
            cfg, [workloads.ChurnSlot(workloads.microbenchmark(6), [(0, 3)]),
                  workloads.ChurnSlot(workloads.web_like(8), [(1, 4)])],
            4, **dev),
        "init_state[free pool, sketch]": lambda: state.init_state(
            cfg, 24, hotness="sketch", **dev),
        "init_hotness": lambda: hotness.init_hotness("neomem", cfg, 24,
                                                     **dev),
        "cms_params": lambda: cms.cms_params(**dev),
        "state_from_numpy": lambda: convert.state_from_numpy(
            state.init_state(cfg, 8, owner, device="cpu"), **dev),
        "init_cache": lambda: kvcache.init_cache(mcfg, cfg, 2, 8, **dev),
        "init_serve_state": lambda: decode.init_serve_state(mcfg, cfg, 2, 8,
                                                            **dev),
        "build_serve_step": lambda: decode.build_serve_step(mcfg, cfg, 2, 8,
                                                            **dev),
        "DenseLM": lambda: DenseLM(mcfg, **dev),
        "params_from_numpy": lambda: convert.params_from_numpy(
            param_tree(), mcfg, **dev),
        "cache_from_numpy": lambda: convert.cache_from_numpy(
            kvcache.init_cache(dataclasses.replace(mcfg, dtype="float32"),
                               cfg, 2, 8, device="cpu"), **dev),
        "launch.serve": lambda: launch_serve.main(cli),
        "HybridLM": lambda: HybridLM(hcfg, **dev),
        "make_model": lambda: make_model(hcfg, **dev),
        "make_prefill_step": lambda: make_prefill_step(hcfg, **dev),
        "init_mamba_cache": lambda: ssm.init_mamba_cache(hcfg, 2, 4, **dev),
        "init_serve_state[hybrid]": lambda: decode.init_serve_state(
            hcfg, cfg, 2, 8, **dev),
        "build_serve_step[hybrid]": lambda: decode.build_serve_step(
            hcfg, cfg, 2, 8, **dev),
        "params_from_numpy[hybrid]": lambda: convert.params_from_numpy(
            param_tree(hcfg), hcfg, **dev),
        "mamba_cache_from_numpy": lambda: convert.mamba_cache_from_numpy(
            ssm.init_mamba_cache(dataclasses.replace(hcfg, dtype="float32"),
                                 2, 4, device="cpu"), **dev),
        "launch.serve[hybrid]": lambda: launch_serve.main(
            ["--arch", "zamba2_7b"] + cli),
        "MoELM": lambda: MoELM(ecfg, **dev),
        "SSMLM": lambda: SSMLM(scfg, **dev),
        "build_serve_step[moe]": lambda: decode.build_serve_step(
            ecfg, cfg, 2, 8, **dev),
        "build_serve_step[ssm]": lambda: decode.build_serve_step(
            scfg, cfg, 2, 8, **dev),
        "init_serve_state[ssm]": lambda: decode.init_serve_state(
            scfg, cfg, 2, 8, **dev),
        "make_prefill_step[moe]": lambda: make_prefill_step(ecfg, **dev),
        "make_prefill_step[ssm]": lambda: make_prefill_step(scfg, **dev),
        "params_from_numpy[moe]": lambda: convert.params_from_numpy(
            param_tree(ecfg), ecfg, **dev),
        "launch.serve[moe]": lambda: launch_serve.main(
            ["--arch", "granite_moe_3b_a800m"] + cli),
        "launch.serve[ssm]": lambda: launch_serve.main(
            ["--arch", "mamba2_130m"] + cli),
        "make_train_step": lambda: make_train_step(mcfg, TrainConfig(),
                                                   **dev),
        "synthetic_batch": lambda: pipeline.synthetic_batch(mcfg, 2, 8,
                                                            **dev),
        "SyntheticLoader": lambda: next(pipeline.SyntheticLoader(
            mcfg, 2, 8, **dev)),
        "opt_state_from_numpy": lambda: convert.opt_state_from_numpy(
            {"m": {"w": np.zeros(2)}, "v": {"w": np.zeros(2)},
             "step": np.int32(0)}, **dev),
        # no step reaches --ckpt-every: the CLI writes no checkpoint, and
        # a fresh --ckpt-dir holds none to resume from
        "launch.train": lambda: _train_cli(launch_train, dev),
        "analysis.main": lambda: analysis_main(
            ["--fixture", "clean"]
            + (["--device", dev["device"]] if dev else [])),
    }


def _train_cli(launch_train, dev: dict):
    with tempfile.TemporaryDirectory() as ckpt:
        return launch_train.main(
            ["--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
             "--ckpt-every", "1000", "--ckpt-dir", ckpt]
            + (["--device", dev["device"]] if dev else []))


CONSTRUCTORS = sorted(_constructors())


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_without_device_raises_on_cpu_only_machine(name,
                                                                no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        _constructors()[name]()


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_runs_on_cpu_when_asked(name):
    """The same calls succeed with ``device="cpu"``, so the raise above is
    the device check and nothing else."""
    _constructors(device="cpu")[name]()
