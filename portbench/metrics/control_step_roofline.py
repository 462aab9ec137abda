"""``control_step_roofline``: the control-step kernel's share of its
roofline, the least time of its frozen work (``counts/control_step.py``)
over its mean device time per launch in the trace, in %."""

from portbench.counts import control_step
from portbench.metrics._kernels import roofline_percent


def read(record: dict):
    return roofline_percent(record, "control_step_kernel",
                            control_step.least_seconds(record["config"], record["traffic"]))
