"""The step-form SSM kernel's work (``csrc/ssm_step.cu``) at the cell's
shape, frozen from what the update needs, whatever implements it.

Per launch, for every env and Mamba head: the float32 state ``[P, N]``
read once and written once (8 bytes per element), ``x`` and ``y`` (4
bytes each per ``P``), ``dt`` (4 bytes), and per env ``B`` and ``C`` (4
bytes each per ``N``), ``A`` and ``D`` once. Arithmetic: 5 operations per
state element (the decay's and the input's products, their sum, the
output's product and its sum), 3 per ``x`` element, 2 per head. The bytes
bound it: at 64 envs, 64 heads of 64 and ``d_state`` 128, 268 MB, about
80 us at 3.35 TB/s.
"""

from __future__ import annotations

from portbench import peaks


def per_launch(cfg: dict, traffic: dict) -> tuple:
    """``(operations, bytes)`` of one launch: every env and head of one
    Mamba layer's step."""
    E = traffic["n_envs"]
    H, P, N = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    state, xs = E * H * P * N, E * H * P
    n_bytes = 4 * (2 * state + 2 * xs + E * H + 2 * E * N + 2 * H)
    return 5 * state + 3 * xs + 2 * E * H, n_bytes


def least_seconds(cfg: dict, traffic: dict):
    """None for a configuration with no Mamba layer."""
    if "mamba_n_heads" not in cfg:
        return None
    ops, n_bytes = per_launch(cfg, traffic)
    return peaks.least_seconds(ops, n_bytes)
