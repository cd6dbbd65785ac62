"""The training step's share of the chip's bf16 peak, in percent: three
times the forward's operations over the batch (recomputation not counted)
for each of the window's untraced steps, over their host-clock time."""
from portbench import work


def read(bench):
    times = [s for s, traced in bench.record.get("train_steps", ())
             if not traced]
    if not times:
        return None
    B, S = bench.record["shape"]
    flops = work.train_step_flops(bench.sizes, B, S) * len(times)
    return 100.0 * flops / sum(times) / work.BF16_FLOPS
