"""``kernels_per_step``: device kernels (copies and fills left out) per
profiled step."""


def read(record: dict):
    trace = record.get("trace") or {}
    ops = trace.get("device_ops") or []
    kernels = [n for n, _, _ in ops if not n.startswith(("Memcpy", "Memset"))]
    return len(kernels) / trace["steps"] if kernels else None
