"""K7's share of its roofline in the prefill, in percent: the least time of
every causal attention call of the traced prefills (bf16 q, k, v and
output; the band's pairs at the bf16 peak) over K7's kernel time."""
from portbench import work

KERNELS = ("flash_attention_",)


def read(bench):
    spans = [s for s in bench.tracer.spans if s.label == "prefill"]
    spent = sum(s.kernel_s(*KERNELS) for s in spans)
    if not spent:
        return None
    z = bench.sizes
    B, S = bench.record["shape"]
    nbytes, flops = work.k7(B, z["num_heads"], z["num_kv_heads"],
                            z["head_dim"], S, z.get("sliding_window"))
    calls = work.family(z).attention_calls(z)
    least = calls * work.bound_s(nbytes, flops, work.BF16_FLOPS)
    return 100.0 * least * len(spans) / spent
