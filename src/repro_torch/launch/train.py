"""Training launcher: config -> model -> train loop with fault tolerance,
checkpointing and (optionally) gradient compression (torch port of the
reference's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama32_1b \\
      --smoke --steps 50 --device cpu

The smoke path exercises the whole stack end to end (loader -> step -> FT
driver -> checkpoints) and prints the reference's lines: the arch, its
parameter count and the mesh; ``resumed from checkpoint at step N`` when
``--ckpt-dir`` holds a checkpoint; the losses, seconds a step, stragglers
and retries.

The port trains on one card. The reference's ``launch/mesh.py`` and
``sharding/`` place the parameters, the optimizer state and the batch on a
(16, 16) or (2, 16, 16) TPU mesh through logical-axis rules; on one device
every axis has size 1, every sharding is the whole tensor on the card and
every collective is the identity, so both collapse to nothing here: the
mesh printed is the one-card {'data': 1, 'model': 1}, and ``--production``
(the 256-chip mesh) is refused. ``--device`` defaults to ``cuda`` and
raises without a card.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import SyntheticLoader
from repro_torch.device import resolve_device
from repro_torch.ft.driver import FTConfig, TrainDriver
from repro_torch.models.params import param_count
from repro_torch.models.transformer import make_model, model_specs
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.step import make_train_step

MESH = {"data": 1, "model": 1}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32_1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--production", action="store_true",
                    help="the reference's 16x16 production mesh (refused)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--remat", default="block")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production:
        ap.error("--production: the port trains on one device; the "
                 "reference's mesh and sharding rules collapse to nothing "
                 "there")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                     total_steps=args.steps, microbatches=args.microbatches,
                     grad_compression=args.grad_compression,
                     remat_policy=args.remat,
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=args.ckpt_every)
    print(f"arch={cfg.name} params={param_count(model_specs(cfg)):,} "
          f"mesh={MESH}")

    model = make_model(cfg, seed=tc.seed, device=dev)
    opt = init_opt_state(model)
    raw_step = make_train_step(cfg, tc, device=dev)

    def step_fn(state, batch):
        model, opt = state
        opt, metrics = raw_step(model, opt, batch)
        return (model, opt), metrics

    loader = SyntheticLoader(cfg, args.batch, args.seq, seed=tc.seed,
                             device=dev)
    ftc = FTConfig(checkpoint_dir=tc.checkpoint_dir,
                   checkpoint_every=tc.checkpoint_every)
    driver = TrainDriver(step_fn, ftc)
    state, start = driver.maybe_restore((model, opt))
    if start:
        print(f"resumed from checkpoint at step {start}")
    if start >= args.steps:
        print(f"nothing to run: the checkpoint at step {start} is at or "
              f"past --steps {args.steps}")
        return

    t0 = time.time()
    state, logs = driver.run(state, loader, start_step=start,
                             num_steps=args.steps - start)
    dt = time.time() - t0
    losses = [float(m["loss"]) for m in logs]
    print(f"steps={len(logs)} loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({dt / max(len(logs), 1):.2f}s/step, "
          f"stragglers={driver.stats.stragglers}, "
          f"retries={driver.stats.retries})")


if __name__ == "__main__":
    main()
