"""The prefill's share of the chip's bf16 peak, in percent: the operations
of the window's untraced requests (the forward over the prompt, logits of
the last position) over their host-clock time."""
from portbench import work


def read(bench):
    times = [s for s, traced in bench.record.get("requests", ()) if not traced]
    if not times:
        return None
    B, S = bench.record["shape"]
    flops = work.forward_flops(bench.sizes, B, S, 1) * len(times)
    return 100.0 * flops / sum(times) / work.BF16_FLOPS
