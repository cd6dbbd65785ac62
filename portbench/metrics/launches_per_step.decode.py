"""Device kernel launches per decode step, over the traced steps (the
profiler's kernel events; copies and fills are not launches of a kernel)."""


def read(bench):
    spans = [s for s in bench.tracer.spans if s.label == "decode_step"]
    if not spans:
        return None
    return sum(s.launches for s in spans) / len(spans)
