"""K5's share of its roofline in decode, in percent: the least time of the
tiered attention's work in the traced steps (every shared-block application
of every step over the valid tokens its sequences hold, read from the
position of the step) over K5's kernel time in them."""
from portbench import work

KERNELS = ("pool_attention_",)


def read(bench):
    spans = [s for s in bench.tracer.spans if s.label == "decode_step"]
    spent = sum(s.kernel_s(*KERNELS) for s in spans)
    if not spent:
        return None
    z, r = bench.sizes, bench.record
    B = r["batch"]
    calls = work.family(z).attention_calls(z)
    least = 0.0
    for s in spans:
        ctx = s.info["position"] + 1
        if z.get("sliding_window") is not None:
            ctx = min(ctx, z["sliding_window"])
        nbytes, flops = work.k5(B, z["num_heads"], z["num_kv_heads"],
                                z["head_dim"], B * ctx, r["Mf"], r["Ms"])
        least += calls * work.bound_s(nbytes, flops, work.BF16_FLOPS)
    return 100.0 * least / spent
