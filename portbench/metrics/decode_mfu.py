"""The decode step's share of the chip's bf16 peak, in percent: the model's
operations in the window's untraced steps (``work.decode_step_flops`` at
each step's position) over their host-clock time."""
from portbench import work


def read(bench):
    steps = [(p, s) for p, s, traced in bench.record.get("steps", ())
             if not traced]
    if not steps:
        return None
    B = bench.record["batch"]
    flops = sum(work.decode_step_flops(bench.sizes, B, p) for p, _ in steps)
    return 100.0 * flops / sum(s for _, s in steps) / work.BF16_FLOPS
