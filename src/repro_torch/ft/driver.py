"""Fault-tolerant training driver (torch port of the reference's
``ft/driver.py``).

Production behaviors, testable on the CPU with injected failures:
  * checkpoint/restart: resume from the latest atomic checkpoint; a step
    that raises is retried after restoring state (transient-failure model);
    repeated failures at the same step abort (poison-step model).
  * straggler mitigation: per-step time (``time.perf_counter``, a clock
    that does not jump) tracked with an EWMA; steps slower than
    ``straggler_factor`` x EWMA are counted and surfaced via the
    ``on_straggler`` hook.
  * heartbeat: a liveness file updated every step (what a cluster agent
    watches to detect a hung worker and restart the job).
  * restore onto the current device: checkpoint leaves are host arrays
    (``maybe_restore(state, device=)``).

A step's time ends when its work on the card has: where the new state
holds a CUDA tensor, the driver synchronizes that device (the reference
blocks on the first leaf). A state holding a module (``(model, opt)``) is
restored in place: the module's parameters are overwritten. The step runs
in the span ``train.step``, its synchronisation in ``train.sync``
(``obs/spans.py``).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import sharded as ckpt
from repro_torch.obs.spans import span


@dataclass
class FTConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    keep: int = 3
    max_retries_per_step: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    heartbeat_file: Optional[str] = None


@dataclass
class FTStats:
    restarts: int = 0
    retries: int = 0
    stragglers: int = 0
    step_time_ewma: float = 0.0
    completed_steps: int = 0


def block_until_ready(state: Any) -> None:
    """Wait for the card that holds the state's first tensor, if any."""
    for leaf in ckpt._flatten(state).values():
        if torch.is_tensor(leaf):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


class TrainDriver:
    """Runs `step_fn(state, batch) -> (state, metrics)` fault-tolerantly."""

    def __init__(self, step_fn: Callable, cfg: FTConfig,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 failure_injector: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.cfg = cfg
        self.stats = FTStats()
        self.on_straggler = on_straggler
        self.failure_injector = failure_injector
        self.ckpt = ckpt.AsyncCheckpointer(cfg.checkpoint_dir, keep=cfg.keep)

    def _heartbeat(self, step: int):
        if self.cfg.heartbeat_file:
            Path(self.cfg.heartbeat_file).write_text(
                json.dumps({"step": step, "t": time.time()}))

    def maybe_restore(self, state: Any, device=None):
        """Resume from the latest checkpoint if one exists."""
        last = ckpt.latest_step(self.cfg.checkpoint_dir)
        if last is None:
            return state, 0
        restored = ckpt.restore(self.cfg.checkpoint_dir, last, state, device)
        self.stats.restarts += 1
        return restored, last + 1

    def run(self, state: Any, batches, start_step: int = 0,
            num_steps: int = 100):
        metrics_log = []
        it = iter(batches)
        step = start_step
        while step < start_step + num_steps:
            batch = next(it)
            retries = 0
            while True:
                t0 = time.perf_counter()
                try:
                    if self.failure_injector is not None:
                        self.failure_injector(step)
                    with span("train.step"):
                        new_state, metrics = self.step_fn(state, batch)
                        with span("train.sync"):
                            block_until_ready(new_state)
                    break
                except RuntimeError:
                    retries += 1
                    self.stats.retries += 1
                    if retries > self.cfg.max_retries_per_step:
                        raise
                    # transient failure: restore the last good state
                    last = ckpt.latest_step(self.cfg.checkpoint_dir)
                    if last is not None:
                        state = ckpt.restore(self.cfg.checkpoint_dir, last,
                                             state)
            dt = time.perf_counter() - t0
            ewma = self.stats.step_time_ewma
            if ewma > 0 and dt > self.cfg.straggler_factor * ewma:
                self.stats.stragglers += 1
                if self.on_straggler:
                    self.on_straggler(step, dt)
            a = self.cfg.ewma_alpha
            self.stats.step_time_ewma = dt if ewma == 0 else (1 - a) * ewma + a * dt

            state = new_state
            metrics_log.append(metrics)
            self.stats.completed_steps += 1
            self._heartbeat(step)
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, state, extra={"step": step})
            step += 1
        self.ckpt.wait()
        return state, metrics_log
