"""K8's share of its roofline in the prefill, in percent: the least time of
every Mamba2 layer's SSD scan of the traced prefills (float32 products
counted as three TF32 products) over K8's kernel time (its three kernels)."""
from portbench import work

KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
           "ssd_chunk_out_kernel")


def read(bench):
    spans = [s for s in bench.tracer.spans if s.label == "prefill"]
    spent = sum(s.kernel_s(*KERNELS) for s in spans)
    if not spent:
        return None
    z = bench.sizes
    m = z["ssm"]
    B, S = bench.record["shape"]
    di = m["expand"] * z["d_model"]
    nbytes, flops = work.k8(B, S, di // m["head_dim"], m["head_dim"],
                            m["state_dim"], m["ngroups"],
                            min(m["chunk_size"], S))
    least = z["num_layers"] * work.bound_s(nbytes, flops, work.F32_FLOPS)
    return 100.0 * least * len(spans) / spent
