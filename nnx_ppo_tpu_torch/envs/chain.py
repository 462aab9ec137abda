"""N-link pendulum ("chain"): analytic articulated-body physics, batched
over envs.

Port of ``nnx_ppo_tpu/envs/chain.py``. Per env and substep it assembles
the full ``[n, n]`` mass matrix of an n-link serial pendulum and solves
``M(θ) θ̈ = τ − C(θ, θ̇) − g(θ)`` with the unrolled Cholesky solve of
``ops/linalg.py::cholesky_solve_small``: dense linear algebra in the env
step, the compute profile of articulated rigid-body dynamics, in plain
PyTorch (no kernel: the JAX env runs no Pallas kernel either).

Dynamics (absolute link angles θᵢ from vertical, point mass mᵢ at the
end of each massless rod lᵢ — standard textbook n-pendulum)::

    M[i,j] = lᵢ lⱼ cos(θᵢ − θⱼ) Σ_{k ≥ max(i,j)} m_k
    C[i]   = Σ_j lᵢ lⱼ sin(θᵢ − θⱼ) θ̇ⱼ² Σ_{k ≥ max(i,j)} m_k
    g[i]   = −g lᵢ sin(θᵢ) Σ_{k ≥ i} m_k        (θ = 0 is *up*)

Task: swing the chain tip up and hold it at maximum height. The env
draws only in ``reset`` (``_draw_reset``, injectable through
``_reset_from``); ``step`` ignores its generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nnx_ppo_tpu_torch.core.device import DeviceConstants
from nnx_ppo_tpu_torch.envs.types import State
from nnx_ppo_tpu_torch.ops.linalg import cholesky_solve_small


class NLinkSwingup(DeviceConstants):
    """Swing-up and balance for an n-link torque-driven pendulum.

    Observation: ``[B, 3n]`` = ``[cos θ, sin θ, θ̇ / 5]`` per link.
    Action: ``[B, n]`` joint torques in [-1, 1] (scaled by ``max_torque``).
    Reward: normalized tip height in [0, 1] minus small velocity and
    torque penalties.
    """

    def __init__(
        self,
        n_links: int = 5,
        link_length: Optional[float] = None,
        link_mass: float = 1.0,
        max_torque: float = 8.0,
        dt: float = 0.02,
        n_substeps: int = 4,
        damping: float = 0.4,
        gravity: float = 9.8,
    ):
        self.n_links = n_links
        # Total length 1.0 by default so tip height is scale-free.
        self.lengths = torch.full((n_links,), link_length or 1.0 / n_links)
        self.masses = torch.full((n_links,), link_mass)
        self.max_torque = max_torque
        self.dt = dt
        self.n_substeps = n_substeps
        self.damping = damping
        self.gravity = gravity
        # tail_mass[i] = sum_{k >= i} m_k ; M uses tail_mass[max(i,j)].
        self._tail_mass = torch.flip(torch.cumsum(torch.flip(self.masses, [0]), 0), [0])
        idx = torch.arange(n_links)
        self._tail_matrix = self._tail_mass[torch.maximum(idx[:, None], idx[None, :])]  # [n, n]
        self._ll = self.lengths[:, None] * self.lengths[None, :]
        self._eye = torch.eye(n_links)
        self.observation_size = 3 * n_links
        self.action_size = n_links

    # -- dynamics ------------------------------------------------------------

    def _accel(self, theta: torch.Tensor, theta_dot: torch.Tensor, tau: torch.Tensor):
        dev = theta.device
        tail, ll = self._on(dev, "_tail_matrix"), self._on(dev, "_ll")
        dth = theta[:, :, None] - theta[:, None, :]
        M = ll * torch.cos(dth) * tail
        # Regularize for the Cholesky (masses are O(1); eps is negligible).
        M = M + 1e-9 * self._on(dev, "_eye")
        C = ((ll * torch.sin(dth) * tail) @ (theta_dot**2)[:, :, None])[:, :, 0]
        g_vec = -self.gravity * self._on(dev, "lengths") * torch.sin(theta) * self._on(
            dev, "_tail_mass"
        )
        rhs = tau - C - g_vec - self.damping * theta_dot
        return cholesky_solve_small(M, rhs)

    def _physics(self, q: dict, action: torch.Tensor) -> dict:
        tau = self.max_torque * torch.clamp(action, -1.0, 1.0).reshape(-1, self.n_links)
        h = self.dt / self.n_substeps
        theta, theta_dot = q["theta"], q["theta_dot"]
        for _ in range(self.n_substeps):
            acc = self._accel(theta, theta_dot, tau)
            theta_dot = torch.clamp(theta_dot + h * acc, -25.0, 25.0)
            theta = theta + h * theta_dot
        return {"theta": theta, "theta_dot": theta_dot}

    # -- task ----------------------------------------------------------------

    def _obs(self, q: dict) -> torch.Tensor:
        return torch.cat(
            [torch.cos(q["theta"]), torch.sin(q["theta"]), q["theta_dot"] / 5.0], dim=-1
        )

    def _state(self, q: dict, action: torch.Tensor) -> State:
        lengths = self._on(q["theta"].device, "lengths")
        total_len = torch.sum(lengths)
        height = torch.sum(lengths * torch.cos(q["theta"]), dim=-1) / total_len  # [-1, 1]
        upright = (height + 1.0) / 2.0
        still = torch.exp(-0.05 * torch.sum(q["theta_dot"] ** 2, dim=-1))
        effort = 0.01 * torch.mean(action**2, dim=-1)
        reward = upright * (0.7 + 0.3 * still) - effort
        return State(
            data=q,
            obs=self._obs(q),
            reward=reward,
            done=torch.zeros_like(reward),
            info={},
            metrics={"tip_height": height, "reward": reward},
        )

    # -- protocol ------------------------------------------------------------

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> dict:
        """Unit-normal ``theta_noise`` and ``theta_dot_noise``, ``[B, n]``."""
        shape, dev = (batch_size, self.n_links), generator.device
        return {
            "theta_noise": torch.randn(shape, generator=generator, device=dev),
            "theta_dot_noise": torch.randn(shape, generator=generator, device=dev),
        }

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def _reset_from(self, draws: dict) -> State:
        # Start hanging down (θ = π) with small noise.
        theta = math.pi + 0.1 * draws["theta_noise"]
        theta_dot = 0.1 * draws["theta_dot_noise"]
        return self._state({"theta": theta, "theta_dot": theta_dot}, torch.zeros_like(theta))

    def step(self, state: State, action: torch.Tensor, generator=None) -> State:
        # The chain draws nothing in step; the generator is ignored.
        del generator
        q = self._physics(state.data, action)
        return self._state(q, action.reshape(-1, self.n_links))
