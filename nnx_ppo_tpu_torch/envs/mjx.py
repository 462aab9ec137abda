"""MuJoCo environment adapter on the MuJoCo-C backend, batched.

Port of ``nnx_ppo_tpu/envs/mjx.py``: :class:`MJXEnv` wraps a raw
``mujoco.MjModel`` as an env, and :class:`MJXCartpoleBalance` is its
physics-backed cart-pole. The JAX adapter switches between MJX
(MuJoCo-XLA, ``impl="mjx"``) and the MuJoCo C engine through a host
callback (``impl="mjc"``). MJX is an XLA program and has no counterpart
in a PyTorch port, so here ``impl="mjc"`` is the one backend
(:mod:`nnx_ppo_tpu_torch.envs.mjc_backend`), ``"auto"`` resolves to it and
``"mjx"`` raises ``ValueError``; :data:`MJX_AVAILABLE` is ``False``.

The JAX env steps one env and is vmapped; this one holds ``[B, ...]``
tensors: ``reset(batch_size, generator)`` and ``step(state, action)``
(the generator is accepted and unused). Subclasses override the task
hooks ``_obs`` / ``_reward`` / ``_done`` on batched data; the reset draws
sit behind ``_draw_reset`` so that a test can inject another package's
draws through ``_reset_from``. ``render`` draws a trajectory with
MuJoCo's own renderer (JAX ``mjx.py:159-175``); it needs an OpenGL
context, and where MuJoCo can make none it raises, as JAX's does. It is
not verified.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from nnx_ppo_tpu_torch.envs.mjc_backend import MJC_AVAILABLE, MJCBackend, mujoco
from nnx_ppo_tpu_torch.envs.types import State

# MJX (MuJoCo-XLA) is an XLA program: the port has no MJX backend.
MJX_AVAILABLE = False


class MJXEnv:
    """A MuJoCo model as a batched env on the MuJoCo C engine (JAX
    ``mjx.py:46``).

    Args:
      mj_model: a ``mujoco.MjModel`` (e.g. ``MjModel.from_xml_string``).
      n_substeps: physics substeps per env step (frame-skip), folded into
        one host call per step.
      reset_noise: uniform qpos / qvel noise half-width at reset.
      impl: ``"auto"`` | ``"mjc"``; ``"mjx"`` raises ``ValueError``.
    """

    def __init__(
        self,
        mj_model: Any,
        n_substeps: int = 4,
        reset_noise: float = 0.05,
        impl: str = "auto",
    ):
        if impl not in ("auto", "mjx", "mjc"):
            raise ValueError(f"impl must be 'auto'|'mjx'|'mjc', got {impl!r}")
        if impl == "mjx":
            raise ValueError(
                "MJXEnv(impl='mjx') has no counterpart in the port: MJX is an XLA "
                "program. Use impl='mjc' (the MuJoCo C engine)."
            )
        if not MJC_AVAILABLE:
            raise ImportError("MJXEnv(impl='mjc') requires the 'mujoco' package.")
        self.impl = "mjc"
        self._mj_model = mj_model
        self._mjc = MJCBackend(mj_model)
        self.n_substeps = n_substeps
        self.reset_noise = reset_noise
        self.action_size = mj_model.nu
        self.observation_size = self._obs(self._mjc.make_data(1)).shape[-1]

    # -- task hooks (override in subclasses) -------------------------------

    def _obs(self, data: Any) -> torch.Tensor:
        return torch.cat([data.qpos, data.qvel], dim=-1)

    def _reward(self, data: Any, action: torch.Tensor) -> Any:
        return torch.zeros(data.qpos.shape[:-1], device=data.qpos.device)

    def _done(self, data: Any) -> torch.Tensor:
        return torch.zeros(data.qpos.shape[:-1], device=data.qpos.device)

    def _metrics(self, data: Any, reward: Any) -> dict:
        return {"reward": reward}

    # -- draws ---------------------------------------------------------------

    def _draw_reset(self, batch_size: int, generator: torch.Generator) -> dict:
        """``qpos_noise[B, nq]`` and ``qvel_noise[B, nv]``, uniform in
        [0, 1)."""
        dev = generator.device
        nq, nv = self._mj_model.nq, self._mj_model.nv
        return {
            "qpos_noise": torch.rand((batch_size, nq), generator=generator, device=dev),
            "qvel_noise": torch.rand((batch_size, nv), generator=generator, device=dev),
        }

    # -- RLEnv protocol -----------------------------------------------------

    def _state(self, data: Any, action: torch.Tensor) -> State:
        reward = self._reward(data, action)
        return State(
            data=data,
            obs=self._obs(data),
            reward=reward,
            done=self._done(data),
            info={},
            metrics=self._metrics(data, reward),
        )

    def reset(self, batch_size: int, generator: torch.Generator) -> State:
        return self._reset_from(self._draw_reset(batch_size, generator))

    def _reset_from(self, draws: dict) -> State:
        u_qpos, u_qvel = draws["qpos_noise"], draws["qvel_noise"]
        B, dev = u_qpos.shape[0], u_qpos.device
        data = self._mjc.make_data(B, dev)
        data = data.replace(
            qpos=data.qpos + self.reset_noise * (u_qpos * 2.0 - 1.0),
            qvel=self.reset_noise * (u_qvel * 2.0 - 1.0),
        )
        return self._state(data, torch.zeros((B, self.action_size), device=dev))

    def step(self, state: State, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> State:
        # The MuJoCo step draws nothing; the generator is ignored.
        del generator
        B = state.data.qpos.shape[0]
        action = torch.clamp(action.reshape(B, self.action_size), -1.0, 1.0)
        data = state.data.replace(ctrl=action.to(state.data.ctrl.dtype))
        # One host round trip covers the whole frame-skip.
        data = self._mjc.step(data, n_substeps=self.n_substeps)
        return self._state(data, action)

    def render(self, trajectory: list, width: int = 320, height: int = 240) -> list:
        """Render a trajectory of SlimStates, one env each, with
        ``mujoco.Renderer`` (JAX ``mjx.py:159-175``): each frame's
        ``qpos`` / ``qvel``, ``mj_forward``, then the scene. Not verified:
        the renderer needs an OpenGL context (``MUJOCO_GL``), and where
        none can be made it raises, as JAX's does."""
        renderer = mujoco.Renderer(self._mj_model, height=height, width=width)
        mj_data = mujoco.MjData(self._mj_model)
        frames = []
        try:
            for slim in trajectory:
                mj_data.qpos[:] = np.asarray(slim.data.qpos)
                mj_data.qvel[:] = np.asarray(slim.data.qvel)
                mujoco.mj_forward(self._mj_model, mj_data)
                renderer.update_scene(mj_data)
                frames.append(renderer.render())
        finally:
            renderer.close()
        return frames


_CARTPOLE_XML = """
<mujoco model="cartpole">
  <option timestep="0.01"/>
  <worldbody>
    <body name="cart" pos="0 0 1">
      <joint name="slide" type="slide" axis="1 0 0" range="-2.5 2.5"/>
      <geom type="box" size="0.2 0.1 0.05" mass="1"/>
      <body name="pole">
        <joint name="hinge" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0 0 0.6" size="0.045" mass="0.1"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="slide" gear="10" ctrlrange="-1 1"/></actuator>
</mujoco>
"""


class MJXCartpoleBalance(MJXEnv):
    """Cart-pole balance on MuJoCo: dm_control-style smooth reward,
    terminate on the cart leaving the track or the pole falling. The
    physics-backed counterpart of ``envs.classic.CartpoleBalance`` (JAX
    ``mjx.py:195``)."""

    def __init__(self, n_substeps: int = 2, impl: str = "auto"):
        if not MJC_AVAILABLE:
            raise ImportError("MJXCartpoleBalance requires 'mujoco'.")
        model = mujoco.MjModel.from_xml_string(_CARTPOLE_XML)
        super().__init__(model, n_substeps=n_substeps, reset_noise=0.05, impl=impl)

    def _obs(self, data: Any) -> torch.Tensor:
        x, theta = data.qpos[..., 0], data.qpos[..., 1]
        return torch.stack(
            [x, torch.cos(theta), torch.sin(theta), data.qvel[..., 0], data.qvel[..., 1]], dim=-1
        )

    def _reward(self, data: Any, action: torch.Tensor) -> torch.Tensor:
        upright = (torch.cos(data.qpos[..., 1]) + 1.0) / 2.0
        centered = torch.exp(
            -0.5 * torch.clamp(torch.abs(data.qpos[..., 0]) - 0.25, min=0.0) ** 2
        )
        return upright * (1.0 + centered) / 2.0

    def _done(self, data: Any) -> torch.Tensor:
        fell = torch.abs(data.qpos[..., 1]) > 0.8
        off_track = torch.abs(data.qpos[..., 0]) > 2.4
        return (fell | off_track).to(torch.float32)
