"""Training steps through the program's fault-tolerant driver.

Set-up builds one training state, the model with its float32 masters and
its AdamW state, and drives it through ``TrainDriver`` (``make_train_step``'s
step) for the first ``checked_steps`` steps, each on its own rows drawn
from the seed; the same state then runs the window's steps, with no
checkpoint in the window. A step ends when the driver has synchronised.

The check, once the window has closed and the program's state is freed:
the plain reference (float32 autograd of the plain forward, a plain AdamW)
follows the same first steps from the same weights and rows, and three
numbers are held to their limits: the worst step's loss gap, the worst
leaf's gap in the norm of the first gradient as the optimizer got it
(read from its first moment after one step), and the worst leaf's gap in
the norm of its change over the checked steps. A leaf's gap is taken
against the reference's norm of that leaf or of the median leaf, whichever
is larger; leaves whose reference gradient is under a thousandth of the
median leaf's are left out (they move by round-off alone).
"""
from __future__ import annotations

import os
import statistics
import tempfile
import time

import torch

from portbench import refs, traffic
from portbench.refs import adamw as ref_adamw
from portbench.refs import common as C

TINY_LEAF = 1e-3


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def train_config(tr: dict):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(learning_rate=tr["learning_rate"],
                       remat_policy=tr["remat"], checkpoint_every=1 << 30)


def batch_of(bench, j: int) -> dict:
    tr = bench.cell["traffic"]
    B, S = tr["batch"], tr["seq_len"]
    t = traffic.tokens(bench.seed, "train", j, (B, S + 1),
                       bench.cfg.vocab_size, bench.device)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def change_norms(bench, tree: dict) -> dict:
    """Each leaf's distance from the weights the seed draws, the seed's
    weights drawn again one leaf at a time (so that set-up holds no second
    copy of the model); ``tree`` is a parameter tree of the model."""
    from portbench.model import draws
    return {k: float(torch.linalg.vector_norm(leaf.detach().float()
                                              - w.float()))
            for k, leaf, w in draws(bench.cfg, tree, bench.seed)}


def gaps(got: dict, want: dict) -> float:
    """The worst leaf's |got - want| against max(want, the median leaf's
    want), over the leaves kept."""
    med = statistics.median(want.values())
    return max(abs(got[k] - w) / max(w, med) for k, w in want.items())


def readings(got: dict, want: dict) -> dict:
    keep = {k for k, g in want["grad"].items()
            if g >= TINY_LEAF * statistics.median(want["grad"].values())}
    return {
        "loss_rel_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["loss"], want["loss"])),
        "grad_norm_gap": gaps({k: got["grad"][k] for k in keep},
                              {k: want["grad"][k] for k in keep}),
        "update_norm_gap": gaps({k: got["change"][k] for k in keep},
                                {k: want["change"][k] for k in keep})}


def reference(bench, mode: str = "float32", half: bool = False) -> dict:
    """The plain reference's first steps from the seed's weights: each
    step's loss, the first step's clipped gradient norms, the change of
    every leaf over the steps. ``half`` is a fault planted in it: the loss
    is the mean over the first half of the batch's tokens, the rest left
    out."""
    tr, tc = bench.cell["traffic"], train_config(bench.cell["traffic"])
    ref = refs.of(bench.cfg.family)
    params = {k: v.detach().requires_grad_(True)
              for k, v in flatten(bench.model().tree()).items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"loss": []}
    for t in range(1, tr["checked_steps"] + 1):
        b = batch_of(bench, t - 1)
        logits = ref.forward(nest(params), bench.sizes, b["tokens"],
                             mode=mode, grad=True)
        keep = logits.shape[1] // 2 if half else logits.shape[1]
        loss = C.cross_entropy(logits[:, :keep], b["labels"][:, :keep])
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        del logits
        out["loss"].append(float(loss.detach()))
        norm = ref_adamw.step(
            params, grads, m, v2, t, lr=tc.learning_rate,
            warmup=tc.warmup_steps, total=tc.total_steps, beta1=tc.beta1,
            beta2=tc.beta2, eps=tc.eps, weight_decay=tc.weight_decay,
            clip=tc.grad_clip)
        if t == 1:
            scale = min(tc.grad_clip / max(norm, 1e-9), 1.0)
            out["grad"] = {k: n * scale for k, n in norms(grads).items()}
        del grads
    del m, v2
    out["change"] = change_norms(bench, nest(params))
    return out


def run(bench) -> None:
    from repro_torch.ft.driver import FTConfig, TrainDriver
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.step import make_train_step
    tr, dev = bench.cell["traffic"], bench.device
    tc = train_config(tr)
    model = bench.model()
    train_step = make_train_step(bench.cfg, tc, device=dev)

    def step_fn(state, batch):
        model, opt = state
        opt, metrics = train_step(model, opt, batch)
        return (model, opt), metrics

    driver = TrainDriver(step_fn, FTConfig(
        checkpoint_dir=os.path.join(tempfile.gettempdir(), "portbench-ckpt"),
        checkpoint_every=1 << 30))
    state = (model, init_opt_state(model))

    def one_step(state, j):
        state, log = driver.run(state, iter([batch_of(bench, j)]),
                                start_step=j, num_steps=1)
        return state, float(log[0]["loss"])

    got = {"loss": []}
    for j in range(tr["checked_steps"]):
        state, loss = one_step(state, j)
        got["loss"].append(loss)
        if j == 0:
            got["grad"] = {k: n / (1 - tc.beta1)
                           for k, n in norms(state[1].m).items()}
    for p in model.parameters():
        p.grad = None
    got["change"] = change_norms(bench, model.tree())
    bench.tracer.warm()
    bench.setup_done()

    trace_at = set(tr["trace_steps"])
    steps = []                          # (seconds, traced)
    t0 = t_prev = time.perf_counter()
    j = tr["checked_steps"]
    while True:
        traced = len(steps) in trace_at
        with bench.tracer.span("train_step", traced):
            state, _ = one_step(state, j)
            t = time.perf_counter()
        steps.append((t - t_prev, traced))
        t_prev = time.perf_counter() if traced else t
        t0 += t_prev - t                  # the trace's reduction is not run
        j += 1
        if t - t0 >= bench.seconds:
            break
    window = t_prev - t0
    bench.attempted = len(steps)
    bench.read_memory_peak()
    del state, model, driver, train_step
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    B, S = tr["batch"], tr["seq_len"]
    bench.e2e["train_tokens_per_s"] = B * S * len(steps) / window
    bench.record.update(train_steps=steps, shape=(B, S))

    want = reference(bench)
    for k, v in readings(got, want).items():
        bench.compare(k, v)
    if bench.control:
        low = reference(bench, mode="fp8")
        half = reference(bench, half=True)
        for name, run_ in (("control", low), ("fault_half_batch", half)):
            for k, v in readings(run_, want).items():
                bench.record[f"{name}_{k}"] = v
