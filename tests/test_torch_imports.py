"""Ground rules of the port that hold on any machine.

* Nothing under ``src/repro_torch/``, nor ``chip_smoke.py``, imports
  ``jax`` or the reference package ``repro`` (checked on the AST, so a
  lazy import inside a function counts too).
* No silent CPU fallback: the entry points default to ``device="cuda"`` and
  raise when no card is present; ``impl="cuda"`` on the CPU raises; a
  kernel wrapper handed a CPU tensor runs the plain version only because
  the tensor lies on the CPU.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core import engine, simulator
from repro_torch.core.workloads import microbenchmark

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
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
