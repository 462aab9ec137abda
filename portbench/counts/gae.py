"""The GAE kernel's work at a minibatch's shape, frozen from what the
algorithm needs, whatever implements it.

Per reward key and minibatch of ``b = n_envs / n_minibatches`` env rows
of ``T`` steps: rewards, values and advantages, float32, each read or
written once (12 bytes per element), the done and truncation flags
shared by the keys (one byte each per element), and the bootstrap value
(4 bytes per row). Arithmetic: 8 operations per element and key (the TD
error, its two selects, the recurrence). The bytes bound it.
"""

from __future__ import annotations

from portbench import peaks

OPS_PER_ELEMENT = 8


def per_launch(cfg: dict, traffic: dict) -> tuple:
    """``(operations, bytes)`` of one launch: every key of one minibatch."""
    b = traffic["n_envs"] // traffic["n_minibatches"]
    T = traffic["rollout_length"]
    keys = len(cfg["reward_keys"])
    n_bytes = b * T * (12 * keys + 2) + 4 * b * keys
    return OPS_PER_ELEMENT * b * T * keys, n_bytes


def least_seconds(cfg: dict, traffic: dict) -> float:
    ops, n_bytes = per_launch(cfg, traffic)
    return peaks.least_seconds(ops, n_bytes)
