"""Pages moved between the tiers per decode step: promotions plus demotions
from the tiering counters of every batch's serve state (``kv.counters``),
over the window's steps."""


def read(bench):
    steps = bench.record.get("migrated_steps")
    if not steps:
        return None
    return bench.record["migrated"] / steps
