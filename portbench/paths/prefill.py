"""Long prompts prefilled back to back through the program's prefill step.

Request j is a prompt of ``batch`` x ``seq_len`` tokens drawn from the seed;
``make_prefill_step`` returns its last position's logits, and the request
ends when its first token is on the host. The next request starts as soon
as one ends (a server with a queue of long prompts).

The check, once the window has closed: a sample of the finished requests,
drawn from the seed, is run through the plain reference, and the largest
distance of the program's last-position logits from the reference's,
relative to the reference's largest logit, is held to its limit.
"""
from __future__ import annotations

import time

import torch

from portbench import check, refs, traffic


def run(bench) -> None:
    from repro_torch.train.step import make_prefill_step
    tr, cfg, dev = bench.cell["traffic"], bench.cfg, bench.device
    shape = (tr["batch"], tr["seq_len"])
    V = cfg.vocab_size
    model = bench.model()
    step = make_prefill_step(cfg, device=dev)

    def prompt(stream: str, j: int):
        return traffic.tokens(bench.seed, stream, j, shape, V, dev)

    step(model, {"tokens": prompt("warmup", 0)}).argmax(-1).cpu()
    bench.tracer.warm()
    bench.setup_done()

    trace_at = set(tr["trace_requests"])
    requests = []           # (seconds, traced)
    logits = []
    t0 = t_prev = time.perf_counter()
    j = 0
    while True:
        traced = j in trace_at
        with bench.tracer.span("prefill", traced):
            out = step(model, {"tokens": prompt("prefill", j)})
            out.argmax(-1).cpu()
            t = time.perf_counter()
        requests.append((t - t_prev, traced))
        logits.append(out)
        t_prev = time.perf_counter() if traced else t
        t0 += t_prev - t                  # the trace's reduction is not run
        j += 1
        if t - t0 >= bench.seconds:
            break
    window = t_prev - t0
    bench.attempted = j
    bench.read_memory_peak()
    del step, out
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    bench.e2e["prefill_tokens_per_s"] = shape[0] * shape[1] * j / window
    bench.record.update(requests=requests, shape=shape)

    # ---- the check ----
    params = model.tree()
    ref = refs.of(cfg.family)
    worst = control = 0.0
    for k in traffic.sample(bench.seed, "check", j, tr["check_requests"]):
        toks = prompt("prefill", k)
        want = ref.forward(params, bench.sizes, toks, last_only=True)[:, 0]
        worst = max(worst, check.logit_rel_err(logits[k], want))
        if bench.control:
            low = ref.forward(params, bench.sizes, toks, mode="fp8",
                              last_only=True)[:, 0]
            control = max(control, check.logit_rel_err(low, want))
    bench.compare("last_logit_rel_err", worst)
    if bench.control:
        bench.record["control_last_logit_rel_err"] = control
