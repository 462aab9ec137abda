"""``step_ms.p90``: the 90th percentile (nearest rank) of the traced
run's per-step host times, each step ending in a synchronize, in ms."""

import math


def read(record: dict):
    steps = sorted(record.get("step_s") or [])
    if not steps:
        return None
    return 1000.0 * steps[max(math.ceil(0.9 * len(steps)) - 1, 0)]
