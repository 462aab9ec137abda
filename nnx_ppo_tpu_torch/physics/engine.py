"""Generic articulated rigid-body dynamics: the part that builds the
mass-matrix factor.

Port of ``nnx_ppo_tpu/physics/engine.py``: ``fwd_kinematics`` (:67, all
four joint types), ``_body_inertias`` (:117), ``mass_matrix`` (:178, the
composite-rigid-body algorithm on 6×6 spatial matrices),
``_scaled_damping`` (:516) and ``mass_matrix_factor`` (:498). The JAX
functions take one env and are vmapped; these take ``qpos[..., nq]`` with
any leading (batch) dimensions and keep the same order of operations.
This is plain PyTorch outside any kernel, as it is XLA outside any kernel
in the JAX package: ``LeggedJoystick(pallas_in_kernel_factor=False)``
builds the factor of ``M(q) + dt·D`` here once per control step and hands
it to the substeps kernel (``cuda_step.make_substep_runner``).

Not ported yet (the manipulation envs, whose models are not free-base
all-hinge, step through the scene control step of
``cuda_scene_step.py`` instead; these wait for the rest of the generic
engine):
``body_velocities``, ``bias_forces`` (RNEA), ``contact_generalized_forces``,
``pair_contact_forces``, ``limit_torques``, ``spring_torques``,
``forward_dynamics``, ``integrate`` and ``step``.

Algorithms follow Featherstone, *Rigid Body Dynamics Algorithms*: CRBA
(ch. 6) for the joint-space inertia matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nnx_ppo_tpu_torch.ops.linalg import cholesky_factor_blocked
from nnx_ppo_tpu_torch.physics.model import BALL, FREE, HINGE, SLIDE, Model
from nnx_ppo_tpu_torch.physics.randomize import DomainParams
from nnx_ppo_tpu_torch.physics.spatial import (
    motion_transform,
    quat_to_rot,
    skew,
    spatial_inertia,
)


class Kinematics(NamedTuple):
    """Per-body frame data (tuples with one entry per body)."""

    X_up: tuple  # [..., 6, 6] motion transform parent→body
    E: tuple  # [..., 3, 3] world_R_body
    p: tuple  # [..., 3] body origin in world
    S: tuple  # [6, nd] joint motion subspace (constant)


def _axis_rotation(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Active rotation by ``angle[...]`` about the constant unit ``axis``
    (Rodrigues), ``[..., 3, 3]``."""
    K = skew(axis)
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None, None]
    return torch.eye(3, dtype=K.dtype, device=K.device) + s * K + (1.0 - c) * (K @ K)


def fwd_kinematics(model: Model, qpos: torch.Tensor) -> Kinematics:
    """Frames of every body from ``qpos[..., nq]``."""
    batch, dev = qpos.shape[:-1], qpos.device

    def const(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    eye3 = torch.eye(3, device=dev).expand(batch + (3, 3))
    X_up, E, p, S = [], [], [], []
    qslices = model.qpos_slices()
    for i, jtype in enumerate(model.joint_type):
        parent = model.parent[i]
        jpos = const(model.joint_pos[i])
        qs, nqi = qslices[i]
        q_i = qpos[..., qs : qs + nqi]
        if parent < 0:
            E_par, p_par = eye3, torch.zeros(batch + (3,), device=dev)
        else:
            E_par, p_par = E[parent], p[parent]
        if jtype == FREE:
            Ei = quat_to_rot(q_i[..., 3:7])
            pi = q_i[..., 0:3]
            # Transform from world coords into the base body frame.
            Xi = motion_transform(Ei.transpose(-1, -2), pi)
            Si = torch.eye(6, device=dev)
        elif jtype == HINGE:
            axis = const(model.joint_axis[i])
            R_j = _axis_rotation(axis, q_i[..., 0])  # parent_R_child
            Ei = E_par @ R_j
            pi = p_par + (E_par @ jpos[..., None])[..., 0]
            Xi = motion_transform(R_j.transpose(-1, -2), jpos.expand(batch + (3,)))
            Si = torch.cat([axis, torch.zeros(3, device=dev)])[:, None]
        elif jtype == SLIDE:
            axis = const(model.joint_axis[i])
            trans = jpos + axis * q_i[..., 0:1]  # origin slides along the axis
            Ei = E_par
            pi = p_par + (E_par @ trans[..., None])[..., 0]
            Xi = motion_transform(eye3, trans)
            Si = torch.cat([torch.zeros(3, device=dev), axis])[:, None]
        elif jtype == BALL:
            R_j = quat_to_rot(q_i)  # parent_R_child (active quaternion)
            Ei = E_par @ R_j
            pi = p_par + (E_par @ jpos[..., None])[..., 0]
            Xi = motion_transform(R_j.transpose(-1, -2), jpos.expand(batch + (3,)))
            # 3 rotational dofs: ω expressed in the child frame.
            Si = torch.cat([torch.eye(3, device=dev), torch.zeros((3, 3), device=dev)], dim=0)
        else:
            raise ValueError(f"unknown joint type {jtype!r}")
        X_up.append(Xi)
        E.append(Ei)
        p.append(pi)
        S.append(Si)
    return Kinematics(tuple(X_up), tuple(E), tuple(p), tuple(S))


def _body_inertias(model: Model, device, params: Optional[DomainParams] = None) -> list:
    """Per-body 6×6 spatial inertias (``[6, 6]``, or ``[B, 6, 6]`` when
    ``params.mass_scale[B]`` scales them: a density scale, mass and
    rotational inertia together, so the COM and the inertia shape stay
    physical)."""
    out = []
    for i in range(model.n_bodies):
        I = spatial_inertia(
            torch.tensor(float(model.mass[i]), device=device),
            torch.tensor(np.asarray(model.com[i]), dtype=torch.float32, device=device),
            torch.tensor(np.asarray(model.inertia[i]), dtype=torch.float32, device=device),
        )
        if params is not None and params.mass_scale is not None:
            I = I * params.mass_scale[..., None, None]
        out.append(I)
    return out


def mass_matrix(model: Model, kin: Kinematics, params: Optional[DomainParams] = None) -> torch.Tensor:
    """CRBA joint-space inertia plus the armature diagonal,
    ``[..., nv, nv]``. ``params`` optionally scales the body inertias
    (armature, a motor property, is not mass-scaled)."""
    NB = model.n_bodies
    slices = model.dof_slices()
    dev = kin.E[0].device
    batch = kin.E[0].shape[:-2]
    Ic = _body_inertias(model, dev, params)
    for i in reversed(range(NB)):
        parent = model.parent[i]
        if parent >= 0:
            X = kin.X_up[i]
            Ic[parent] = Ic[parent] + X.transpose(-1, -2) @ Ic[i] @ X
    M = torch.zeros(batch + (model.nv, model.nv), device=dev)
    for i in range(NB):
        si, ni = slices[i]
        F = Ic[i] @ kin.S[i]  # [..., 6, ni]
        M[..., si : si + ni, si : si + ni] = kin.S[i].T @ F
        j = i
        while model.parent[j] >= 0:
            F = kin.X_up[j].transpose(-1, -2) @ F
            j = model.parent[j]
            sj, nj_ = slices[j]
            block = kin.S[j].T @ F  # [..., nj_, ni]
            M[..., sj : sj + nj_, si : si + ni] = block
            M[..., si : si + ni, sj : sj + nj_] = block.transpose(-1, -2)
    return M + torch.diag(torch.tensor(np.asarray(model.armature), dtype=torch.float32, device=dev))


def _scaled_damping(model: Model, device, params: Optional[DomainParams] = None) -> torch.Tensor:
    """Per-dof viscous damping ``[nv]`` (``[B, nv]`` with a per-env
    ``damping_scale``)."""
    damping = torch.tensor(np.asarray(model.damping), dtype=torch.float32, device=device)
    if params is not None and params.damping_scale is not None:
        damping = damping * params.damping_scale[..., None]
    return damping


def mass_matrix_factor(
    model: Model, qpos: torch.Tensor, *, dt: float, params: Optional[DomainParams] = None
) -> torch.Tensor:
    """Lower Cholesky factor of ``M(q) + dt·D``, ``[..., nv, nv]``, for
    callers that hold the factor across several substeps. ``dt`` is
    required (keyword-only): the implicit joint-damping term is baked into
    the factor, so it must match the integration step the factor is used
    with; pass ``dt=0.0`` explicitly for undamped continuous dynamics."""
    with torch.no_grad():
        kin = fwd_kinematics(model, qpos.to(torch.float32))
        M = mass_matrix(model, kin, params)
        if dt:
            M = M + dt * torch.diag_embed(_scaled_damping(model, qpos.device, params))
        return cholesky_factor_blocked(M)
