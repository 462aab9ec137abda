"""``mfu``: the whole step's network FLOPs (``counts/networks.py``) over
the traced run's timed window, as a share of the H100's peak in the
configuration's stated compute precision, in %."""

from portbench import peaks
from portbench.counts import networks


def read(record: dict):
    if not record.get("steps") or not record.get("window_s"):
        return None
    flops = networks.flops_per_step(record["config"], record["traffic"]) * record["steps"]
    return 100.0 * flops / record["window_s"] / peaks.FLOPS[record["config"]["compute_dtype"]]
