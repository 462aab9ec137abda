"""``ssm_step_roofline``: the step-form SSM kernel's share of its
roofline at the cell's shape, the least time of its frozen work
(``counts/ssm_step.py``) over its mean device time per launch in the
trace, in %; None where the trace holds no launch of it."""

from portbench.counts import ssm_step
from portbench.metrics._kernels import roofline_percent


def read(record: dict):
    return roofline_percent(record, "ssm_step_kernel",
                            ssm_step.least_seconds(record["config"], record["traffic"]))
