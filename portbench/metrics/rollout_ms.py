"""``rollout_ms``: the mean host duration of the program's
``unroll_env`` range per step, in ms, over the profiled steps."""


def read(record: dict):
    spans = ((record.get("trace") or {}).get("ranges") or {}).get("unroll_env")
    return 1000.0 * sum(spans) / len(spans) if spans else None
