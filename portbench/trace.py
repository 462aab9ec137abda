"""The traced run's reading of the device: ``torch.profiler`` over a few
whole steps, reduced to the record the per-layer readers take.

The record's ``trace`` holds the profiled window (from the first
``ppo_step`` range's start to the later of the last range's end and the
last device operation's end), the device operations in it (name, start,
duration; the device copies of host annotations, which carry a host
operation's name, left out), the host
durations of the program's ``record_function`` ranges, the union of the
device operations' intervals (``busy_s``) and the breakdown: the device
operations that took most time and the longest idle gaps, each named by
the host range and operation it fell in.
"""

from __future__ import annotations

import collections
from typing import Callable

import torch

RANGES = ("ppo_step", "unroll_env", "ppo_update")
TOP = 10
NAME_CHARS = 160


def _events(prof) -> list:
    """``(name, on_device, start_s, duration_s)`` of every event."""
    return [(e.name(), "CUDA" in str(e.device_type()), e.start_ns() * 1e-9,
             e.duration_ns() * 1e-9) for e in prof.profiler.kineto_results.events()]


def _union(intervals: list) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def profile(step: Callable[[], None], n_steps: int) -> dict:
    """Profile ``n_steps`` calls of ``step`` and reduce the trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    return reduce(_events(prof), n_steps)


def reduce(events: list, n_steps: int) -> dict:
    host = [(n, s, s + d) for n, dev, s, d in events if not dev]
    # The device copies of host annotations (the program's ranges, the
    # optimizer's ``Optimizer.step#...``) carry their host names.
    annotations = {n for n, _, _ in host}
    device = [(n, s, s + d) for n, dev, s, d in events if dev and n not in annotations]
    steps = [(s, e) for n, s, e in host if n == "ppo_step"]
    if not steps or not device:
        return {"steps": n_steps, "device_ops": [], "ranges": {}, "window_s": 0.0,
                "busy_s": 0.0, "breakdown": {"device_ops": [], "idle_gaps": []}}
    lo = min(s for s, _ in steps)
    hi = max(max(e for _, e in steps), max(e for _, _, e in device))
    device = [(n, s, e) for n, s, e in device if e > lo and s < hi]
    busy = _union([(max(s, lo), min(e, hi)) for _, s, e in device])
    ranges = collections.defaultdict(list)
    for n, s, e in host:
        if n in RANGES:
            ranges[n].append(e - s)
    by_name = collections.Counter()
    for n, s, e in device:
        by_name[n[:NAME_CHARS]] += e - s
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy[:-1], busy[1:])]
    gaps = sorted(gaps, reverse=True)[:TOP]
    named_gaps = [[_where(host, (s + e) / 2), length] for length, s, e in gaps]
    return {
        "steps": n_steps,
        "device_ops": [(n, s - lo, e - s) for n, s, e in device],
        "ranges": dict(ranges),
        "window_s": hi - lo,
        "busy_s": sum(e - s for s, e in busy),
        "breakdown": {"device_ops": [[n, t] for n, t in by_name.most_common(TOP)],
                      "idle_gaps": named_gaps},
    }


def _where(host: list, t: float) -> str:
    """The innermost of the program's ranges and the innermost host
    operation that hold time ``t``."""
    holding = [(s, n) for n, s, e in host if s <= t <= e]
    if not holding:
        return "(no host operation)"
    ranges = sorted((s, n) for s, n in holding if n in RANGES)
    ops = sorted((s, n) for s, n in holding if n not in RANGES)
    parts = ([ranges[-1][1]] if ranges else []) + ([ops[-1][1][:NAME_CHARS]] if ops else [])
    return " > ".join(parts)
