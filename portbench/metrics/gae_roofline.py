"""``gae_roofline``: the GAE kernel's share of its roofline at the
minibatch's shape, the least time of its frozen work (``counts/gae.py``)
over its mean device time per launch in the trace, in %."""

from portbench.counts import gae
from portbench.metrics._kernels import roofline_percent


def read(record: dict):
    return roofline_percent(record, "gae_kernel", gae.least_seconds(record["config"],
                                                                      record["traffic"]))
