"""``model_mfu``: the whole step's network FLOPs, from the count of the
configuration's own name (``counts/<config name>.py``, its
``flops_per_step``), over the traced run's timed window, as a share of
the H100's peak in the configuration's stated compute precision, in %;
None where the configuration has no such count."""

import importlib.util

from portbench import cells, peaks


def read(record: dict):
    name = f"portbench.counts.{record['config']['name']}"
    if not record.get("steps") or not record.get("window_s") or \
            importlib.util.find_spec(name) is None:
        return None
    count = cells.load_module("counts", record["config"]["name"])
    flops = count.flops_per_step(record["config"], record["traffic"]) * record["steps"]
    return 100.0 * flops / record["window_s"] / peaks.FLOPS[record["config"]["compute_dtype"]]
