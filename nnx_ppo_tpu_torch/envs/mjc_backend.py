"""MuJoCo-C physics backend for :class:`~nnx_ppo_tpu_torch.envs.mjx.MJXEnv`.

Port of ``nnx_ppo_tpu/envs/mjc_backend.py``: the same ``MJXEnv`` adapter
running on the plain MuJoCo C engine, ``mujoco`` itself and no
``mujoco-mjx``. The JAX backend reaches the host through
``jax.pure_callback`` with ``vmap_method="broadcast_all"`` (:19-25), so a
vmapped env batch arrives as one callback. The port's envs are batched
natively, so :meth:`MJCBackend.step` is that callback called directly:
the ``[B, ...]`` state goes to host numpy, the host loops the envs
through one reused ``MjData`` (lock-guarded: ``MjData`` is not
thread-safe) with ``n_substeps`` folded into the one call, and the result
comes back as float32 tensors on the caller's device. This runs on the
CPU only; nothing of it is a kernel.

The state is the minimal MuJoCo state vector ``(qpos, qvel, act)`` plus
``ctrl`` and ``time``, exactly what ``mj_step`` consumes and produces.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

try:  # exercised only where mujoco is installed
    import mujoco

    MJC_AVAILABLE = True
except ImportError:
    mujoco = None
    MJC_AVAILABLE = False


@dataclasses.dataclass(frozen=True)
class MJCData:
    """Batched MuJoCo state, ``[B, ...]`` float32 tensors: the ``mj_step``
    state vector plus controls (the field subset of ``mjx.Data`` that the
    adapter and its task hooks touch; JAX ``mjc_backend.py:49``)."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    act: torch.Tensor
    ctrl: torch.Tensor
    time: torch.Tensor

    def replace(self, **kw: Any) -> "MJCData":
        return dataclasses.replace(self, **kw)


class MJCBackend:
    """``make_data`` / ``step`` on the MuJoCo C engine (JAX
    ``mjc_backend.py:69``). One instance owns one ``MjModel`` and a reused
    ``MjData`` scratch."""

    def __init__(self, mj_model: Any):
        if not MJC_AVAILABLE:
            raise ImportError("MJCBackend requires the 'mujoco' package.")
        self.model = mj_model
        self._scratch = mujoco.MjData(mj_model)
        self._lock = threading.Lock()
        self.nq, self.nv, self.na, self.nu = mj_model.nq, mj_model.nv, mj_model.na, mj_model.nu

    def make_data(self, batch_size: int, device=None) -> MJCData:
        """``batch_size`` copies of the model's reference state."""
        B = batch_size
        qpos0 = torch.tensor(np.asarray(self.model.qpos0), dtype=torch.float32, device=device)
        return MJCData(
            qpos=qpos0.expand(B, self.nq).clone(),
            qvel=torch.zeros((B, self.nv), device=device),
            act=torch.zeros((B, self.na), device=device),
            ctrl=torch.zeros((B, self.nu), device=device),
            time=torch.zeros((B,), device=device),
        )

    # -- host side ----------------------------------------------------------

    def _host_step(self, qpos, qvel, act, ctrl, time, n_substeps: int):
        """``n_substeps`` of ``mj_step`` for every env of a ``[B, ...]``
        numpy batch, in float64; returns float32 ``(qpos, qvel, act,
        time)``."""
        qpos = np.atleast_2d(np.asarray(qpos, np.float64))
        qvel = np.atleast_2d(np.asarray(qvel, np.float64))
        act = np.asarray(act, np.float64).reshape(qpos.shape[0], self.na)
        ctrl = np.asarray(ctrl, np.float64).reshape(qpos.shape[0], self.nu)
        time = np.asarray(time, np.float64).reshape(qpos.shape[0])
        B = qpos.shape[0]
        out_qpos = np.empty_like(qpos)
        out_qvel = np.empty_like(qvel)
        out_act = np.empty_like(act)
        out_time = np.empty_like(time)
        with self._lock:
            d = self._scratch
            for b in range(B):
                mujoco.mj_resetData(self.model, d)
                d.qpos[:] = qpos[b]
                d.qvel[:] = qvel[b]
                if self.na:
                    d.act[:] = act[b]
                if self.nu:
                    d.ctrl[:] = ctrl[b]
                d.time = time[b]
                for _ in range(n_substeps):
                    mujoco.mj_step(self.model, d)
                out_qpos[b] = d.qpos
                out_qvel[b] = d.qvel
                if self.na:
                    out_act[b] = d.act
                out_time[b] = d.time
        f32 = lambda x: x.astype(np.float32)
        return f32(out_qpos), f32(out_qvel), f32(out_act), f32(out_time)

    # -- tensor side ----------------------------------------------------------

    def step(self, data: MJCData, n_substeps: int = 1) -> MJCData:
        """Advance ``n_substeps`` physics steps for the whole batch (one
        host round trip); the result lies on ``data.qpos``'s device."""
        host = [x.detach().cpu().numpy() for x in (data.qpos, data.qvel, data.act, data.ctrl,
                                                   data.time)]
        qpos, qvel, act, time = self._host_step(*host, n_substeps)
        dev = data.qpos.device
        return data.replace(
            qpos=torch.from_numpy(qpos).to(dev),
            qvel=torch.from_numpy(qvel).to(dev),
            act=torch.from_numpy(act).to(dev),
            time=torch.from_numpy(time).to(dev),
        )
