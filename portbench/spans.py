"""The program's spans on the card: the Kineto events of the traced run's
profile (the two steps ``trace.profile`` records) reduced to, for each
span name, its calls, host time, device time, kernels, idle time and
blocking runtime calls.

A span is a ``record_function`` range (``is_user_annotation()``): the
program's own (``ppo_step``, ``unroll_env``, ``rollout.env``,
``ppo_update``, ``update.loss``, ``update.backward``,
``update.optimizer``) and those of ``torch.optim``
(``Optimizer.step#...``). The attribution:

* a device operation (kernel, copy, fill) belongs to the CUDA runtime
  call that launched it, by the ``correlation_id()`` both carry;
* a launch belongs to the innermost span whose interval holds the
  launch's start, by time, on any thread: autograd launches the
  backward's kernels from its own device thread while the main thread
  sits inside ``update.backward``;
* each idle interval of the device (the window less the union of its
  operations) belongs whole to the innermost span holding its midpoint
  on the host, the rule of ``trace.py``'s breakdown, with the interval
  first moved onto the host's clock: it ends where the launch of the
  operation that ends it starts, since the card waited for that launch
  (not before the window's start). On the card the device's clock, as
  the trace gives it, drifts from the host's by up to milliseconds over
  a profile; this compares host times and device durations only. The
  window's tail, which no operation ends, is taken as it is;
* a blocking runtime call (``SYNCS``) belongs to the innermost span
  holding its start.

A span's inclusive figures hold those of every span nested in it, its
self figures only what fell to it as the innermost. The window and the
busy intervals are ``trace.reduce``'s. Times are read in integer ns.

Until ``trace.profile`` stores this record itself, run it beside the
traced run with the run's own arguments::

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> --trace 1

which prints the run's line and then the span record's.
"""

from __future__ import annotations

import bisect
import collections
import json
import sys

# ``run`` first: its clock for ``setup_s`` starts when it is imported.
from portbench import run, trace

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
CLOCK_SLACK_NS = 5_000
FIELDS = ("calls", "host_s", "device_s", "device_self_s", "kernels", "idle_s", "idle_self_s",
          "syncs", "other_thread_launches")
NS = 1e-9


def events(prof) -> list:
    """``(name, on_device, start_ns, duration_ns, thread, correlation,
    user_annotation)`` of every event."""
    return [(e.name(), "CUDA" in str(e.device_type()), e.start_ns(), e.duration_ns(),
             e.start_thread_id(), e.correlation_id(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


class _Timeline:
    """The spans' boundaries and, on each segment between two, the
    holding spans as ``(name, thread)``, innermost (latest start) first."""

    def __init__(self, spans: list):
        self.points = sorted({t for _, s, e, _ in spans for t in (s, e)})
        self.holding = []
        for t in self.points:
            held = sorted((s, -e, name, thread) for name, s, e, thread in spans if s <= t < e)
            self.holding.append([(name, thread) for _, _, name, thread in reversed(held)])

    def at(self, t: int) -> list:
        i = bisect.bisect_right(self.points, t) - 1
        return self.holding[i] if i >= 0 else []


def reduce(raw: list, n_steps: int) -> dict:
    """The span record of ``raw`` (:func:`events`) over ``n_steps`` steps:
    ``window_s``, ``busy_s``, ``device_s`` (the operations' summed time in
    the window), ``coverage`` (the share of ``device_s`` whose launch was
    found), ``early_ops`` (operations starting more than 5 µs before
    their launch: the host and device clocks disagree), ``launch_lag_s``
    (for each step, the least time from a launch to the start of its
    operation: a few µs where the clocks agree) and, by span name,
    ``calls``, ``host_s``, ``device_s`` and ``device_self_s``, ``kernels``
    (copies and fills left out), ``idle_s`` and ``idle_self_s``,
    ``syncs`` and ``other_thread_launches`` (operations launched from
    another thread than the span's); all but ``*_self_s`` inclusive, all
    summed over the steps."""
    host = [(n, s, s + d, th, c, a) for n, dev, s, d, th, c, a in raw if not dev]
    device = [(n, s, s + d, c) for n, dev, s, d, _, c, a in raw if dev and not a]
    steps = [(s, e) for n, s, e, _, _, a in host if a and n == "ppo_step"]
    record = {"steps": n_steps, "window_s": 0.0, "busy_s": 0.0, "device_s": 0.0,
              "coverage": 0.0, "early_ops": 0, "launch_lag_s": [], "spans": {}}
    if not steps or not device:
        return record
    lo = min(s for s, _ in steps)
    hi = max(max(e for _, e in steps), max(e for _, _, e, _ in device))
    device = [(n, max(s, lo), min(e, hi), s, c) for n, s, e, c in device if e > lo and s < hi]
    spans = [(n, s, e, th) for n, s, e, th, _, a in host if a and lo <= s <= hi]
    runtime = {c: (s, th) for n, s, _, th, c, a in host if not a and n.startswith("cu")}
    timeline = _Timeline(spans)
    out = collections.defaultdict(lambda: dict.fromkeys(FIELDS, 0))
    for n, s, e, _ in spans:
        out[n]["calls"] += 1
        out[n]["host_s"] += (e - s) * NS

    def put(holding: list, key: str, value, self_key: str = None) -> None:
        for name in dict(holding):
            out[name][key] += value
        if self_key and holding:
            out[holding[0][0]][self_key] += value

    step_starts = sorted(s for s, _ in steps)
    lags = [None] * len(step_starts)
    found_ns = early = busy_ns = 0
    edge = lo
    for n, s, e, start, c in sorted(device, key=lambda d: d[1]):
        launched, thread = runtime.get(c, (None, None))
        if s > edge:  # an idle interval, which this operation ends
            at = (edge + s) // 2 if launched is None else max(launched - (s - edge) // 2, lo)
            put(timeline.at(at), "idle_s", (s - edge) * NS, "idle_self_s")
        busy_ns += max(e - max(s, edge), 0)
        edge = max(edge, e)
        if launched is None:
            continue
        found_ns += e - s
        early += start < launched - CLOCK_SLACK_NS
        k = max(bisect.bisect_right(step_starts, launched) - 1, 0)
        lags[k] = start - launched if lags[k] is None else min(lags[k], start - launched)
        holding = timeline.at(launched)
        put(holding, "device_s", (e - s) * NS, "device_self_s")
        put(holding, "kernels", 0 if n.startswith(("Memcpy", "Memset")) else 1)
        put([(name, th) for name, th in holding if th != thread], "other_thread_launches", 1)
    if hi > edge:
        put(timeline.at((edge + hi) // 2), "idle_s", (hi - edge) * NS, "idle_self_s")
    for n, s, _, _, _, a in host:
        if not a and n in SYNCS and lo <= s <= hi:
            put(timeline.at(s), "syncs", 1)
    device_ns = sum(e - s for _, s, e, _, _ in device)
    record.update(window_s=(hi - lo) * NS, busy_s=busy_ns * NS, device_s=device_ns * NS,
                  coverage=found_ns / device_ns, early_ops=early,
                  launch_lag_s=[lag if lag is None else lag * NS for lag in lags],
                  spans=dict(out))
    return record


def main(argv=None) -> None:
    """``portbench.run`` with ``argv``; its profile is also reduced to
    the span record, printed as a JSON line after the run's."""
    records = []
    read = trace._events

    def read_both(prof) -> list:
        records.append(reduce(events(prof), run.PROFILED_STEPS))
        return read(prof)

    trace._events = read_both
    try:
        run.main(argv)
    finally:
        trace._events = read
    for record in records:
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
