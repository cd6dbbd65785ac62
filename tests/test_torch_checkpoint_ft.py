"""The port's checkpoints and fault-tolerant driver: the reference's six
cases (``tests/test_checkpoint_ft.py``, with ``restore(..., device=)`` in
place of its elastic re-sharding), checkpoints crossing between the two
packages bitwise (a reference ``save`` restored by the port and the
reverse, on that file's ``_tree()`` and on a smoke model's (params, opt)
state), and the training CLI resuming from its checkpoint."""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import sharded as jckpt
from repro.configs import get_smoke_config as j_smoke
from repro.models.params import init_params as j_init_params
from repro.models.transformer import model_specs as j_specs
from repro.optim.adamw import init_opt_state as j_init_opt
from repro_torch import convert
from repro_torch.checkpoint import sharded as ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.ft.driver import FTConfig, TrainDriver
from repro_torch.launch import train as t_launch
from repro_torch.models.transformer import make_model
from repro_torch.optim.adamw import OptState, init_opt_state
from repro_torch.train.step import make_train_step

CPU = "cpu"


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"w": torch.ones((5,), dtype=torch.int32),
                  "scale": torch.tensor(2.5)}}


def _j_tree():
    return {"a": jnp.arange(12.0).reshape(3, 4),
            "b": {"w": jnp.ones((5,), jnp.int32),
                  "scale": jnp.asarray(2.5)}}


def _leaves(tree) -> dict:
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in ckpt._flatten(tree).items()}


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert np.array_equal(la[k], lb[k]), k


# ------------------------------------------- the reference's six cases ----
def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, extra={"note": "x"})
    assert ckpt.latest_step(str(tmp_path)) == 7
    r = ckpt.restore(str(tmp_path), 7, t)
    _same(t, r)
    assert ckpt.restore_extra(str(tmp_path))["note"] == "x"


def test_gc_keeps_latest(tmp_path):
    t = _tree()
    for s in range(6):
        ckpt.save(str(tmp_path), s, t, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 2 and steps[-1] == "step_00000005"


def test_async_checkpointer(tmp_path):
    t = _tree()
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(3, t)
    t["a"].add_(1)                       # the host copy was taken inline
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    r = ckpt.restore(str(tmp_path), 3, t)
    assert torch.equal(r["a"], torch.arange(12.0).reshape(3, 4))


def test_ft_driver_restart_and_straggler(tmp_path):
    """Inject a transient failure; driver restores and completes. A slow step
    is flagged as a straggler."""
    state = {"x": torch.zeros(())}
    fails = {"armed": True}
    stragglers = []

    def step_fn(s, batch):
        if batch == 13 and fails["armed"]:
            fails["armed"] = False
            raise RuntimeError("injected node failure")
        if batch == 17:
            time.sleep(0.15)
        else:
            time.sleep(0.01)
        return {"x": s["x"] + 1}, {"step_metric": batch}

    cfg = FTConfig(checkpoint_dir=str(tmp_path), checkpoint_every=5,
                   straggler_factor=3.0, heartbeat_file=str(tmp_path / "hb"))
    drv = TrainDriver(step_fn, cfg,
                      on_straggler=lambda s, dt: stragglers.append(s))
    state, logs = drv.run(state, iter(range(100)), num_steps=25)
    assert drv.stats.retries == 1
    assert drv.stats.completed_steps == 25
    assert 17 in stragglers
    assert (tmp_path / "hb").exists()
    assert json.loads((tmp_path / "hb").read_text())["step"] == 24
    assert ckpt.latest_step(str(tmp_path)) is not None


def test_restore_onto_a_device(tmp_path):
    """The one-card form of the reference's elastic restore: leaves are
    host arrays, put on the device ``restore`` is given, whatever device
    the saved or the ``like`` leaves lay on; ``meta`` leaves describe the
    structure alone."""
    t = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt.save(str(tmp_path), 0, t)
    like = {"w": torch.empty((4, 4), device="meta")}
    r = ckpt.restore(str(tmp_path), 0, like, device=torch.device(CPU))
    assert r["w"].device == torch.device(CPU)
    assert torch.equal(r["w"], t["w"])
    r = ckpt.restore(str(tmp_path), 0, like)
    assert r["w"].device == torch.device(CPU) and torch.equal(r["w"],
                                                              t["w"])


def test_resume_from_latest(tmp_path):
    state = {"x": torch.zeros(())}

    def step_fn(s, batch):
        return {"x": s["x"] + 1}, {}

    cfg = FTConfig(checkpoint_dir=str(tmp_path), checkpoint_every=5)
    drv = TrainDriver(step_fn, cfg)
    state, _ = drv.run(state, iter(range(100)), num_steps=12)
    # "crash": new driver resumes from step 10 checkpoint
    drv2 = TrainDriver(step_fn, cfg)
    restored, start = drv2.maybe_restore({"x": torch.zeros(())})
    assert start == 10
    assert float(restored["x"]) == 10.0


# ------------------------------------------------ across the packages ----
def test_reference_save_restores_in_the_port_and_back(tmp_path):
    jckpt.save(str(tmp_path / "j"), 4, _j_tree(), extra={"k": 1})
    r = ckpt.restore(str(tmp_path / "j"), None, _tree())
    _same(r, {k: v for k, v in jax.tree_util.tree_map(
        np.asarray, _j_tree()).items()})
    assert ckpt.restore_extra(str(tmp_path / "j")) == {"k": 1}
    ckpt.save(str(tmp_path / "t"), 5, _tree())
    back = jckpt.restore(str(tmp_path / "t"), None, _j_tree())
    _same(_tree(), back)
    # the same files and manifests on both sides
    jckpt.save(str(tmp_path / "t2"), 5, _j_tree())
    for name in ("manifest.json",):
        assert (json.loads((tmp_path / "t" / "step_00000005" / name
                            ).read_text()) ==
                json.loads((tmp_path / "t2" / "step_00000005" / name
                            ).read_text()))


def test_model_and_optimizer_state_cross_both_ways(tmp_path):
    """A smoke model's (params, opt) after one training step: saved by the
    port, restored by the reference with its own tree as ``like`` and
    the reverse, every leaf bitwise (float32 parameters and moments, the
    int32 step)."""
    arch = "llama32_1b"
    cfg = get_smoke_config(arch)
    model = make_model(cfg, seed=0, device=CPU)
    opt = init_opt_state(model)
    opt, _ = make_train_step(cfg, TrainConfig(), device=CPU)(
        model, opt, synthetic_batch(cfg, 2, 8, device=CPU))
    ckpt.save(str(tmp_path / "t"), 1, (model, opt))
    j_params = j_init_params(jax.random.PRNGKey(0), j_specs(j_smoke(arch)))
    j_state = (j_params, j_init_opt(j_params))
    restored = jckpt.restore(str(tmp_path / "t"), 1, j_state)
    params_np = convert.params_to_numpy(model)
    opt_np = convert.opt_state_to_numpy(opt)
    got = {".".join(str(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", k)))) for k in p): np.asarray(v) for p, v in
        jax.tree_util.tree_flatten_with_path(restored)[0]}
    want = {f"0.{k}": v for k, v in _dot(params_np).items()}
    want.update({f"1.{f}.{k}": v for f in ("m", "v")
                 for k, v in _dot(opt_np[f]).items()})
    want["1.step"] = opt_np["step"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    # the reverse: the reference saves its restored tree, the port
    # restores it into a fresh model and state
    jckpt.save(str(tmp_path / "j"), 2, restored)
    fresh = make_model(cfg, seed=5, device=CPU)
    m2, o2 = ckpt.restore(str(tmp_path / "j"), 2,
                          (fresh, init_opt_state(fresh)))
    assert m2 is fresh and isinstance(o2, OptState)
    _same((model, opt), (m2, o2))


def _dot(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dot(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_bf16_leaf_round_trips_as_its_bits(tmp_path):
    t = {"w": torch.randn(3, 5).to(torch.bfloat16)}
    ckpt.save(str(tmp_path), 0, t)
    m = json.loads((tmp_path / "step_00000000" / "manifest.json"
                    ).read_text())
    assert m["leaves"]["w"]["dtype"] == "bfloat16"
    r = ckpt.restore(str(tmp_path), 0, t)
    assert r["w"].dtype == torch.bfloat16 and torch.equal(r["w"], t["w"])


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--smoke", "--device", CPU, "--steps", "12", "--ckpt-every",
            "5", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    t_launch.main(argv)
    out = capsys.readouterr().out
    assert "arch=llama32-smoke" in out and "steps=12 loss" in out
    assert "resumed" not in out
    assert ckpt.latest_step(str(tmp_path)) == 9
    t_launch.main(argv)
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 10" in out
    assert "steps=2 loss" in out
    with pytest.raises(SystemExit):
        t_launch.main(argv + ["--production"])


def test_train_cli_past_its_steps_runs_nothing(tmp_path, capsys):
    argv = ["--smoke", "--device", CPU, "--ckpt-every", "5", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path)]
    t_launch.main(argv + ["--steps", "12"])
    capsys.readouterr()
    t_launch.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 10" in out
    assert "nothing to run" in out and "steps=" not in out
    assert ckpt.latest_step(str(tmp_path)) == 9
