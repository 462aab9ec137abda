"""``idle_share``: the share of the profiled window in which no device
operation ran, ``1 - busy / window``, in %."""


def read(record: dict):
    trace = record.get("trace") or {}
    if not trace.get("window_s") or not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
