"""``update_ms``: the mean host duration of the program's ``ppo_update``
range per step, in ms, over the profiled steps."""


def read(record: dict):
    spans = ((record.get("trace") or {}).get("ranges") or {}).get("ppo_update")
    return 1000.0 * sum(spans) / len(spans) if spans else None
