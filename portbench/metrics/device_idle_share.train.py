"""Share of the traced training steps' wall time in which no device
operation ran, in percent (the union of the device intervals against the
wall)."""


def read(bench):
    spans = [s for s in bench.tracer.spans if s.label == "train_step"]
    wall = sum(s.wall_s for s in spans)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(s.busy_s for s in spans) / wall)
