"""Shared by the per-layer readers: a kernel's share of its roofline
from the traced device operations."""

from __future__ import annotations


def roofline_percent(record: dict, kernel_name: str, least_seconds):
    """``100 * least / measured``, the measured time the mean device
    time of the launches whose name holds ``kernel_name``; None where
    the trace holds none or the configuration has no count."""
    trace = record.get("trace") or {}
    times = [d for name, _, d in trace.get("device_ops", []) if kernel_name in name]
    if not times or least_seconds is None:
        return None
    return 100.0 * least_seconds / (sum(times) / len(times))
