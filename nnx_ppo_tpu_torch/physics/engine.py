"""Articulated rigid-body dynamics: CRBA + RNEA + penalty contacts.

Port of ``nnx_ppo_tpu/physics/engine.py``, the generic engine: one env is
a pure function of (static :class:`~nnx_ppo_tpu_torch.physics.model.Model`,
``qpos``, ``qvel``). The JAX functions take one env and are vmapped;
these take tensors with any leading (batch) dimensions (``qpos[..., nq]``,
``qvel[..., nv]``; per-body frames ``[..., 3, 3]`` / ``[..., 6, 6]``) and
keep the same order of operations. Every body loop is a Python loop over
the static tree, as JAX unrolls it at trace time, and every contact is a
branch-free ``where`` mask.

Ported: ``fwd_kinematics`` (:67, all four joint types),
``_body_inertias`` (:117), ``body_velocities`` (:137), ``bias_forces``
(:147, RNEA with gravity as a base acceleration), ``mass_matrix`` (:178,
CRBA), ``contact_generalized_forces`` (:206, flat ground, an analytic
``Terrain`` or a ``HeightGrid``; sphere-sphere pairs), ``geom_world_centers``
(:342), ``body_point_velocity`` (:350), ``sphere_pair_force`` (:357),
``project_spatial_forces`` (:399), ``project_world_point_forces`` (:418),
``limit_torques`` (:433), ``spring_torques`` (:473), ``mass_matrix_factor``
(:498), ``_scaled_damping`` (:516), ``forward_dynamics`` (:523),
``integrate`` (:589) and ``step`` (:633, a Python loop over substeps in
place of ``lax.scan``).

This is plain PyTorch: on the card each operation is an eager launch, as
each is an XLA operation in the JAX package. The envs reach it through
``substep_impl="xla"`` (or ``"auto"`` for a model or feature set that the
control-step and scene kernels do not support); ``LeggedJoystick(
pallas_in_kernel_factor=False)`` builds its factor here once per control
step for the substeps kernel.

Algorithms follow Featherstone, *Rigid Body Dynamics Algorithms*: RNEA
(ch. 5) for bias forces with the gravity-as-base-acceleration trick, CRBA
(ch. 6) for the joint-space inertia matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nnx_ppo_tpu_torch.ops.linalg import (
    cholesky_backsub,
    cholesky_factor_blocked,
    cholesky_solve_small,
)
from nnx_ppo_tpu_torch.physics.model import BALL, FREE, HINGE, SLIDE, Model
from nnx_ppo_tpu_torch.physics.randomize import DomainParams
from nnx_ppo_tpu_torch.physics.spatial import (
    crf,
    crm,
    motion_transform,
    quat_integrate,
    quat_to_rot,
    skew,
    spatial_inertia,
)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product ``A @ x`` over leading dimensions
    (``A[..., m, n]``, ``x[..., n]`` -> ``[..., m]``)."""
    return (A @ x[..., None])[..., 0]


def _t(A: torch.Tensor) -> torch.Tensor:
    """Transpose of the last two dimensions."""
    return A.transpose(-1, -2)


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


def body_velocities(model: Model, kin: Kinematics, qvel: torch.Tensor) -> list:
    """Spatial velocity ``[..., 6]`` of every body in its own frame (JAX
    ``engine.py:137``)."""
    v = []
    for i, (start, nd) in enumerate(model.dof_slices()):
        vj = _mv(kin.S[i], qvel[..., start : start + nd])
        parent = model.parent[i]
        v.append(vj if parent < 0 else _mv(kin.X_up[i], v[parent]) + vj)
    return v


def bias_forces(
    model: Model, kin: Kinematics, qvel: torch.Tensor, v: list,
    params: Optional[DomainParams] = None,
) -> torch.Tensor:
    """RNEA with q̈ = 0: Coriolis + centrifugal + gravity + joint damping,
    ``[..., nv]`` (JAX ``engine.py:147``). ``params``: optional per-env
    inertia / damping scales."""
    NB = model.n_bodies
    dev = qvel.device
    I = _body_inertias(model, dev, params)
    # Gravity trick: give the world an upward pseudo-acceleration.
    a_world = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, -model.gravity], dtype=torch.float32,
                           device=dev)
    a, f = [], []
    for i, (start, nd) in enumerate(model.dof_slices()):
        vj = _mv(kin.S[i], qvel[..., start : start + nd])
        a_par = a_world if model.parent[i] < 0 else a[model.parent[i]]
        ai = _mv(kin.X_up[i], a_par) + _mv(crm(v[i]), vj)
        a.append(ai)
        f.append(_mv(I[i], ai) + _mv(crf(v[i]), _mv(I[i], v[i])))
    per_body = [None] * NB
    for i in reversed(range(NB)):
        per_body[i] = _mv(kin.S[i].T, f[i])
        parent = model.parent[i]
        if parent >= 0:
            f[parent] = f[parent] + _mv(_t(kin.X_up[i]), f[i])
    # dof slices are contiguous in body order: one concatenation.
    C = torch.cat(per_body, dim=-1)
    return C + _scaled_damping(model, dev, params) * qvel


def geom_world_centers(model: Model, kin: Kinematics) -> list:
    """World-frame centers ``[..., 3]`` of every contact sphere (JAX
    ``engine.py:342``)."""
    dev = kin.p[0].device
    return [
        kin.p[b] + _mv(kin.E[b], torch.tensor(np.asarray(model.geom_offset[g]),
                                              dtype=torch.float32, device=dev))
        for g, b in enumerate(model.geom_body)
    ]


def body_point_velocity(kin: Kinematics, v: list, b: int, r_local: torch.Tensor) -> torch.Tensor:
    """World velocity of body ``b``'s material point at body-frame offset
    ``r_local`` (JAX ``engine.py:350``)."""
    w, vl = v[b][..., :3], v[b][..., 3:]
    return _mv(kin.E[b], vl + torch.linalg.cross(w, r_local.expand_as(w), dim=-1))


def _friction_force(friction, fn: torch.Tensor, vt: torch.Tensor, friction_vel: float):
    """Smooth-Coulomb friction ``-μ·fn·vt / max(|vt|, friction_vel)``
    (``|vt|`` regularized by 1e-6), in JAX's order of operations."""
    vt_norm = torch.sqrt(torch.sum(vt**2, dim=-1) + 1e-6)
    return (-friction * fn)[..., None] * vt / torch.clamp(vt_norm, min=friction_vel)[..., None]


def sphere_pair_force(
    xa: torch.Tensor,
    xb: torch.Tensor,
    ra: torch.Tensor,
    rb: torch.Tensor,
    *,
    stiffness: float,
    damping: float,
    friction,
    va_fn,
    vb_fn,
    friction_vel: float = 0.1,
    max_force: float = float("inf"),
) -> tuple:
    """Penalty force between two spheres at world centers ``xa`` / ``xb``
    (``[..., 3]``; radii ``ra`` / ``rb`` float32 tensors; JAX
    ``engine.py:357``).

    ``va_fn`` / ``vb_fn`` map a world contact point to that body's
    material velocity there. Returns ``(f_world on b, contact point,
    fn)``; body a gets ``-f_world`` (equal and opposite at the same
    point, so the pair conserves momentum). Shared by intra-tree
    self-collision pairs and the cross-tree pairs of ``scene.py``.
    """
    d = xb - xa
    dist = torch.sqrt(torch.sum(d**2, dim=-1) + 1e-12)
    n = d / dist[..., None]  # contact normal, a → b
    phi = ra + rb - dist
    c_w = xa + n * (ra - 0.5 * phi)[..., None]  # contact point, world
    v_rel = vb_fn(c_w) - va_fn(c_w)
    sep = torch.sum(n * v_rel, dim=-1)  # separation rate (= -φ̇)
    fn = torch.where(
        phi > 0.0,
        torch.clamp(stiffness * phi - damping * sep, min=0.0),
        torch.zeros_like(phi),
    )
    if np.isfinite(max_force):
        fn = torch.clamp(fn, max=max_force)
    vt = v_rel - sep[..., None] * n
    ft = _friction_force(friction, fn, vt, friction_vel)
    return fn[..., None] * n + ft, c_w, fn


def _radius(model: Model, g: int, device) -> torch.Tensor:
    """Geom ``g``'s radius as a float32 scalar tensor (JAX's
    ``jnp.float32``), so that sums of radii round in float32."""
    return torch.tensor(float(model.geom_radius[g]), dtype=torch.float32, device=device)


def _spatial_point_force(r_local: torch.Tensor, f_b: torch.Tensor) -> torch.Tensor:
    """Body-frame point force at ``r_local`` as a spatial force at the
    body origin: ``[r × f; f]``."""
    return torch.cat([torch.linalg.cross(r_local.expand_as(f_b), f_b, dim=-1), f_b], dim=-1)


def contact_generalized_forces(
    model: Model, kin: Kinematics, v: list, terrain=None, params: Optional[DomainParams] = None
) -> tuple:
    """Penalty contacts -> (generalized force ``[..., nv]``, per-contact
    normal force ``[..., NG + NP]``: the ground contacts first, then the
    model's sphere-sphere pairs in declaration order; JAX
    ``engine.py:206``).

    ``terrain``: ``None`` keeps the flat z = 0 plane; an analytic
    :class:`~nnx_ppo_tpu_torch.physics.terrain.Terrain` or a
    :class:`~nnx_ppo_tpu_torch.physics.terrain.HeightGrid` gives
    penetration, normal and friction plane from the surface at each
    geom's center. Forces are gathered per body (Python lists, rebound
    and never written in place) and mapped to generalized coordinates by
    one backward pass over the tree (:func:`project_spatial_forces`).
    """
    f_ext: list = [None] * model.n_bodies
    normals = []
    dev = kin.p[0].device
    centers = geom_world_centers(model, kin)
    # Friction: the per-env draw ([...] tensor) or the model's constant.
    friction = model.friction
    if params is not None and params.friction is not None:
        friction = params.friction

    def point_velocity(b: int, r_local: torch.Tensor) -> torch.Tensor:
        return body_point_velocity(kin, v, b, r_local)

    def apply_force(b: int, r_local: torch.Tensor, f_w: torch.Tensor) -> None:
        f_sp = _spatial_point_force(r_local, _mv(_t(kin.E[b]), f_w))
        f_ext[b] = f_sp if f_ext[b] is None else f_ext[b] + f_sp

    down = torch.tensor([0.0, 0.0, -1.0], device=dev)
    for g, b in enumerate(model.geom_body):
        offset = torch.tensor(np.asarray(model.geom_offset[g]), dtype=torch.float32, device=dev)
        radius = _radius(model, g, dev)
        E_b = kin.E[b]
        if terrain is None:
            # Flat plane: the normal is the constant +z. The contact point
            # is the sphere's lowest point, one radius below the center.
            phi = radius - centers[g][..., 2]  # penetration (>0 in contact)
            contact_offset = offset + _mv(_t(E_b), down) * radius
            v_pt = point_velocity(b, contact_offset)
            fn = torch.where(
                phi > 0.0,
                torch.clamp(
                    model.contact_stiffness * phi - model.contact_damping * v_pt[..., 2], min=0.0
                ),
                torch.zeros_like(phi),
            )
            if np.isfinite(model.max_contact_force):
                fn = torch.clamp(fn, max=model.max_contact_force)
            ft = _friction_force(friction, fn, v_pt[..., :2], model.friction_vel)
            f_w = torch.cat([ft, fn[..., None]], dim=-1)
        else:
            # Heightfield: surface normal at the center's xy; the gap along
            # the normal is the vertical gap times n_z (exact on planes).
            c = centers[g]
            n = terrain.normal(c[..., :2])
            phi = radius - (c[..., 2] - terrain.height(c[..., :2])) * n[..., 2]
            contact_offset = offset + _mv(_t(E_b), -n * radius)
            v_pt = point_velocity(b, contact_offset)
            vn = torch.sum(n * v_pt, dim=-1)
            fn = torch.where(
                phi > 0.0,
                torch.clamp(model.contact_stiffness * phi - model.contact_damping * vn, min=0.0),
                torch.zeros_like(phi),
            )
            if np.isfinite(model.max_contact_force):
                fn = torch.clamp(fn, max=model.max_contact_force)
            ft = _friction_force(friction, fn, v_pt - vn[..., None] * n, model.friction_vel)
            f_w = fn[..., None] * n + ft
        normals.append(fn)
        apply_force(b, contact_offset, f_w)

    # Sphere-sphere pairs (self-collision): the same spring-damper normal
    # and smooth-Coulomb friction, equal and opposite at the midpoint of
    # the penetration axis, so pair forces conserve momentum.
    for ga, gb in zip(model.pair_geom_a, model.pair_geom_b):
        ba, bb = model.geom_body[ga], model.geom_body[gb]

        def local_velocity(c, b):
            return point_velocity(b, _mv(_t(kin.E[b]), c - kin.p[b]))

        f_w, c_w, fn = sphere_pair_force(
            centers[ga],
            centers[gb],
            _radius(model, ga, dev),
            _radius(model, gb, dev),
            stiffness=model.contact_stiffness,
            damping=model.contact_damping,
            friction=friction,
            friction_vel=model.friction_vel,
            max_force=model.max_contact_force,
            va_fn=lambda c, b=ba: local_velocity(c, b),
            vb_fn=lambda c, b=bb: local_velocity(c, b),
        )
        normals.append(fn)
        apply_force(bb, _mv(_t(kin.E[bb]), c_w - kin.p[bb]), f_w)
        apply_force(ba, _mv(_t(kin.E[ba]), c_w - kin.p[ba]), -f_w)

    tau = project_spatial_forces(model, kin, f_ext)
    if normals:
        return tau, torch.stack(normals, dim=-1)
    return tau, torch.zeros(kin.p[0].shape[:-1] + (0,), device=dev)


def project_spatial_forces(model: Model, kin: Kinematics, f_ext: list) -> torch.Tensor:
    """Map per-body spatial forces (body frame, at the body origin;
    ``None`` = no force) to generalized coordinates ``[..., nv]`` with one
    backward pass over the tree, the ``Xᵀ`` propagation RNEA uses (JAX
    ``engine.py:399``). Rebinds the entries of ``f_ext``."""
    batch, dev = kin.p[0].shape[:-1], kin.p[0].device
    per_body = []
    for i in reversed(range(model.n_bodies)):
        fi = f_ext[i]
        if fi is None:
            per_body.append(torch.zeros(batch + (model.dof_slices()[i][1],), device=dev))
            continue
        per_body.append(_mv(kin.S[i].T, fi))
        parent = model.parent[i]
        if parent >= 0:
            up = _mv(_t(kin.X_up[i]), fi)
            f_ext[parent] = up if f_ext[parent] is None else f_ext[parent] + up
    return torch.cat(per_body[::-1], dim=-1)


def project_world_point_forces(model: Model, kin: Kinematics, forces: list) -> torch.Tensor:
    """Generalized forces ``[..., nv]`` from world-frame point forces:
    ``forces`` is a list of ``(body_index, point_world, f_world)`` (JAX
    ``engine.py:418``). The scene layer applies cross-tree contact forces
    to a tree with it."""
    f_ext: list = [None] * model.n_bodies
    for b, point_w, f_w in forces:
        E_T = _t(kin.E[b])
        f_sp = _spatial_point_force(_mv(E_T, point_w - kin.p[b]), _mv(E_T, f_w))
        f_ext[b] = f_sp if f_ext[b] is None else f_ext[b] + f_sp
    return project_spatial_forces(model, kin, f_ext)


def _one_dof_gather(model: Model) -> tuple:
    """The static qpos index of every dof (``[nv]``) and a mask of the
    dofs of 1-dof (hinge / slide) joints."""
    qpos_idx = np.zeros(model.nv, np.int64)
    one_dof = np.zeros(model.nv, np.float32)
    qslices, vslices = model.qpos_slices(), model.dof_slices()
    for i, jtype in enumerate(model.joint_type):
        (qs, _), (vs, _) = qslices[i], vslices[i]
        if jtype in (HINGE, SLIDE):
            qpos_idx[vs] = qs
            one_dof[vs] = 1.0
    return qpos_idx, one_dof


def limit_torques(model: Model, qpos: torch.Tensor, qvel: torch.Tensor) -> Optional[torch.Tensor]:
    """Joint-range penalty torques ``[..., nv]`` (spring-damper on the
    violation, damping only while violating; JAX ``engine.py:433``), or
    ``None`` when no dof is limited. Limits apply to 1-dof joints; ±inf bounds fold to zero
    force."""
    lower, upper = model.joint_lower, model.joint_upper
    if lower.size == 0 or not (np.isfinite(lower).any() or np.isfinite(upper).any()):
        return None
    qpos_idx, one_dof = _one_dof_gather(model)
    limited = one_dof * (np.isfinite(lower) | np.isfinite(upper))
    dev = qpos.device
    q = qpos[..., torch.from_numpy(qpos_idx).to(dev)]
    lo = torch.tensor(np.asarray(lower), dtype=torch.float32, device=dev)
    hi = torch.tensor(np.asarray(upper), dtype=torch.float32, device=dev)
    below = torch.clamp(lo - q, min=0.0)  # -inf bound -> 0
    above = torch.clamp(q - hi, min=0.0)  # +inf bound -> 0
    violating = ((below + above) > 0.0).to(torch.float32)
    tau = model.limit_stiffness * (below - above) - model.limit_damping * violating * qvel
    return tau * torch.tensor(limited, dtype=torch.float32, device=dev)


def spring_torques(model: Model, qpos: torch.Tensor) -> Optional[torch.Tensor]:
    """Passive joint-spring torques ``-k·(q - ref)`` ``[..., nv]`` on 1-dof
    joints (JAX ``engine.py:473``), or ``None`` when no dof has a spring."""
    k = model.spring_stiffness
    if k.size == 0 or not (k > 0).any():
        return None
    qpos_idx, one_dof = _one_dof_gather(model)
    dev = qpos.device
    q = qpos[..., torch.from_numpy(qpos_idx).to(dev)]
    k_dof = torch.tensor(np.asarray(k * one_dof), dtype=torch.float32, device=dev)
    ref = torch.tensor(np.asarray(model.spring_ref), dtype=torch.float32, device=dev)
    return -k_dof * (q - ref)


def forward_dynamics(
    model: Model,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    tau_applied: torch.Tensor,
    dt: float = 0.0,
    chol: Optional[torch.Tensor] = None,
    external_forces: Optional[list] = None,
    terrain=None,
    params: Optional[DomainParams] = None,
) -> tuple:
    """``(M + dt·D) q̈ = τ_applied + τ_contact − C`` (D = joint damping):
    returns ``(qacc[..., nv], per-contact normal forces [..., NG + NP])``
    (JAX ``engine.py:523``).

    ``dt`` makes the viscous joint damping implicit (MuJoCo's
    ``implicitfast``); ``dt=0`` is the plain continuous dynamics.
    ``chol``: a :func:`mass_matrix_factor` built with the same ``dt``,
    held over several substeps (then ``dt`` is not consulted).
    ``external_forces``: world-frame point forces ``[(body, point_world
    [..., 3], f_world [..., 3])]`` from outside the tree (pushes, the
    scene's cross-tree contacts). ``terrain``: see
    :func:`contact_generalized_forces`. ``params``: per-env
    :class:`~nnx_ppo_tpu_torch.physics.randomize.DomainParams` overrides."""
    kin = fwd_kinematics(model, qpos)
    v = body_velocities(model, kin, qvel)
    C = bias_forces(model, kin, qvel, v, params)
    tau_c, normals = contact_generalized_forces(model, kin, v, terrain, params)
    rhs = tau_applied + tau_c - C
    tau_l = limit_torques(model, qpos, qvel)
    if tau_l is not None:
        rhs = rhs + tau_l
    tau_s = spring_torques(model, qpos)
    if tau_s is not None:
        rhs = rhs + tau_s
    if external_forces:
        rhs = rhs + project_world_point_forces(model, kin, external_forces)
    if chol is not None:
        return cholesky_backsub(chol, rhs), normals
    M = mass_matrix(model, kin, params)
    if dt:
        M = M + dt * torch.diag_embed(_scaled_damping(model, qpos.device, params))
    return cholesky_solve_small(M, rhs), normals


def integrate(
    model: Model, qpos: torch.Tensor, qvel: torch.Tensor, qacc: torch.Tensor, dt: float
) -> tuple:
    """Semi-implicit Euler: velocity first, then configuration (free-base
    and ball orientations by the quaternion exponential map; JAX
    ``engine.py:589``). Contiguous hinge / slide spans integrate as one
    vector operation."""
    qvel_new = qvel + dt * qacc
    if not any(t in (FREE, BALL) for t in model.joint_type):
        return qpos + dt * qvel_new, qvel_new

    segments = []
    qslices, vslices = model.qpos_slices(), model.dof_slices()
    linear_start: Optional[int] = None  # open hinge/slide run (qpos index)
    linear_vstart = 0

    def flush(end_q, end_v):
        if linear_start is not None:
            segments.append(
                qpos[..., linear_start:end_q] + dt * qvel_new[..., linear_vstart:end_v]
            )

    for i, jtype in enumerate(model.joint_type):
        (qs, nqi), (vs, nvi) = qslices[i], vslices[i]
        if jtype in (HINGE, SLIDE):
            if linear_start is None:
                linear_start, linear_vstart = qs, vs
            continue
        flush(qs, vs)
        linear_start = None
        q_i, v_i = qpos[..., qs : qs + nqi], qvel_new[..., vs : vs + nvi]
        if jtype == FREE:
            E = quat_to_rot(q_i[..., 3:7])
            segments.append(q_i[..., 0:3] + dt * _mv(E, v_i[..., 3:6]))
            segments.append(quat_integrate(q_i[..., 3:7], v_i[..., 0:3], dt))
        else:  # BALL: child-frame relative ω, the same convention as FREE
            segments.append(quat_integrate(q_i, v_i, dt))
    flush(model.nq, model.nv)
    return torch.cat(segments, dim=-1), qvel_new


def step(
    model: Model,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    tau_applied: torch.Tensor,
    dt: float,
    n_substeps: int = 1,
    terrain=None,
    params: Optional[DomainParams] = None,
) -> tuple:
    """Advance ``n_substeps`` physics steps of ``dt`` under constant
    applied torque (JAX ``engine.py:633``, a Python loop in place of
    ``lax.scan``). Returns ``(qpos, qvel, the last substep's normal
    forces)``."""
    normals = None
    for _ in range(n_substeps):
        qacc, normals = forward_dynamics(
            model, qpos, qvel, tau_applied, dt=dt, terrain=terrain, params=params
        )
        qpos, qvel = integrate(model, qpos, qvel, qacc, dt)
    return qpos, qvel, normals
