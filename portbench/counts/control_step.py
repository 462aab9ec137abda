"""The control-step kernel's work per launch, frozen at the
``quadruped_rough`` configuration's features, whatever implements it.

Operations: 98,931 float operations per env for one control step (the
held factor of ``M + dt D``, ten substeps on six-wave analytic terrain
with four domain-randomization lanes and a push), counted on the
reference's lane math (``reference/physics/engine_soa.py``) by counting
every elementwise arithmetic operation per output element (sin, cos,
sqrt, division one each), on 8 envs. Bytes: every input and output once,
float32: qpos (19), qvel (18) and target (12) in, the 7 extra lanes (4
DR scalars, 3 push) in, qpos and qvel out and the 8 contact normal
forces out: 404 bytes per env.
"""

from __future__ import annotations

from portbench import peaks

FROZEN = {
    # configuration -> (operations per env, bytes per env)
    "quadruped_rough": (98_931, 404),
}


def per_launch(cfg: dict, traffic: dict):
    """``(operations, bytes)`` of one launch over the cell's envs, or
    None where the configuration runs no control step."""
    counts = FROZEN.get(cfg["name"])
    if counts is None:
        return None
    n = traffic["n_envs"] // traffic["world_size"]
    return counts[0] * n, counts[1] * n


def least_seconds(cfg: dict, traffic: dict):
    work = per_launch(cfg, traffic)
    return None if work is None else peaks.least_seconds(*work)
