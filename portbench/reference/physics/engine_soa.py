"""The plain lane math of one physics substep of the legged robot: the
reference's copy of the port's plain version of the control-step kernel
(``nnx_ppo_tpu_torch/physics/engine_soa.py`` as it stood when the
benchmark was written), kept here so that the yardstick does not move
when the port does.

One semi-implicit-Euler substep: kinematics, velocities, RNEA bias,
penalty contacts with the ground (analytic terrain), PD, push, the
back-substitution with a Cholesky factor of ``M + armature + dt·D``,
integration. Every scalar is a ``[B]`` lane and the model's constants
are Python floats, in the order of operations of the port's version.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.physics import soa
from portbench.reference.physics.model import FREE, HINGE, Model


def _const3(x):
    return (float(x[0]), float(x[1]), float(x[2]))


def _const9(M):
    M = np.asarray(M, dtype=float)
    return tuple(float(v) for v in M.reshape(-1))


def _terrain_height_soa(terrain, x, y):
    """Analytic terrain height on lanes — lane form of
    ``Terrain.height`` (the wave parameters are Python floats)."""
    h = terrain.slope[0] * x + terrain.slope[1] * y
    for a, f, d, p in zip(terrain.amplitudes, terrain.frequencies,
                          terrain.directions, terrain.phases):
        h = h + a * torch.sin(f * (d[0] * x + d[1] * y) + p)
    return h


def _terrain_normal_soa(terrain, x, y):
    """Upward unit surface normal on lanes — lane form of
    ``Terrain.normal`` (normalize([-grad, 1]))."""
    gx = torch.zeros_like(x) + terrain.slope[0]
    gy = torch.zeros_like(y) + terrain.slope[1]
    for a, f, d, p in zip(terrain.amplitudes, terrain.frequencies,
                          terrain.directions, terrain.phases):
        c = a * f * torch.cos(f * (d[0] * x + d[1] * y) + p)
        gx = gx + d[0] * c
        gy = gy + d[1] * c
    inv = 1.0 / torch.sqrt(gx * gx + gy * gy + 1.0)
    return (-gx * inv, -gy * inv, inv)


def _kin_soa(model: Model, qpos):
    """Per-body kinematics on lane tuples: world rotations ``E`` (9-lane
    tuples), world origins ``P`` (3-lane), ``Rcp`` (child_R_parent, 9),
    constant joint anchors, and each body's joint index (None at the
    free base). Shared by the substep and the in-kernel CRBA."""
    NB = model.n_bodies
    pos = qpos[0:3]
    quat = qpos[3:7]
    jq = qpos[7:]
    E = [None] * NB
    P = [None] * NB
    Rcp = [None] * NB
    jpos_c = [None] * NB
    joint_of_body = [None] * NB
    jq_cursor = 0
    for i, jtype in enumerate(model.joint_type):
        parent = model.parent[i]
        jp = _const3(model.joint_pos[i])
        jpos_c[i] = jp
        if jtype == FREE:
            E[i] = soa.quat_to_m3(quat)
            P[i] = pos
            Rcp[i] = None  # base transform handled specially
        else:
            joint_of_body[i] = jq_cursor
            axis = _const3(model.joint_axis[i])
            R_j = soa.axis_angle_m3(axis, jq[jq_cursor])  # parent_R_child
            jq_cursor += 1
            E_par, P_par = E[parent], P[parent]
            E[i] = soa.m3_mul(E_par, R_j)
            P[i] = soa.v3_add(P_par, soa.m3_vec(E_par, jp))
            # child_R_parent = R_jᵀ (row-major transpose)
            Rcp[i] = (
                R_j[0], R_j[3], R_j[6],
                R_j[1], R_j[4], R_j[7],
                R_j[2], R_j[5], R_j[8],
            )
    return E, P, Rcp, jpos_c, joint_of_body


def crba_chol_soa(model: Model, qpos, dt: float, *,
                  mass_scale=None, damping_scale=None):
    """CRBA mass matrix + unrolled Cholesky of ``M + armature + dt·D``
    on lane tuples — the form the control-step kernel computes in
    registers and local memory.

    ``mass_scale`` / ``damping_scale``: optional per-env lanes (the
    scalar :class:`DomainParams` fields).
    CRBA is linear in the body inertias, so a scalar density scale
    multiplies the whole unscaled ``M`` — armature (rotor inertia, a
    motor property) stays unscaled, and the implicit ``dt·D`` diagonal
    takes the damping scale.

    Building the factor inside the control-step kernel keeps the
    ``[B, nv, nv]`` matrix out of device memory: per control step the
    kernel reads ``qpos/qvel/target`` once and writes the integrated
    state once.

    Returns the nested lower-triangular lane tuple ``chol[i][j]``
    (i ≥ j) that :func:`substep_soa` consumes.
    """
    assert model.free_base and all(
        t in (FREE, HINGE) for t in model.joint_type
    ), "crba_chol_soa supports free-base all-hinge models"
    NB = model.n_bodies
    nv = model.nv
    E, _, Rcp, jpos_c, joint_of_body = _kin_soa(model, qpos)
    lane = qpos[0]

    def aslane(x):
        return x if hasattr(x, "shape") else torch.full_like(lane, x)

    # Composite spatial inertias per body, kept as 3x3 blocks
    # (ang-ang A, ang-lin B, lin-lin C; the lin-ang block is Bᵀ).
    # Leaves start as python-float tuples; they become lane tuples the
    # first time a child's (orientation-dependent) contribution folds in.
    def const_blocks(i):
        m = float(model.mass[i])
        c = np.asarray(model.com[i], np.float64)
        cx = np.array([[0.0, -c[2], c[1]],
                       [c[2], 0.0, -c[0]],
                       [-c[1], c[0], 0.0]])
        I6 = np.block([
            [np.asarray(model.inertia[i], np.float64) + m * cx @ cx.T,
             m * cx],
            [m * cx.T, m * np.eye(3)],
        ])
        blk = lambda r, c: tuple(float(v) for v in I6[r:r + 3, c:c + 3]
                                 .reshape(-1))
        return [blk(0, 0), blk(0, 3), blk(3, 3)]

    Ic = [const_blocks(i) for i in range(NB)]

    for i in reversed(range(1, NB)):
        # Congruence Y = X_upᵀ Ic X_up with X = [[Eᵢ, 0], [-U, Eᵢ]],
        # Eᵢ = child_R_parent, U = Eᵢ·skew(jpos) (constant skew).
        Ei = Rcp[i]
        r = jpos_c[i]
        sk = (0.0, -r[2], r[1], r[2], 0.0, -r[0], -r[1], r[0], 0.0)
        U = soa.m3_mul(Ei, sk)
        A, B, C = Ic[i]
        Bt = soa.m3_transpose(B)
        W11 = soa.m3_sub(soa.m3_mul(A, Ei), soa.m3_mul(B, U))
        W12 = soa.m3_mul(B, Ei)
        W21 = soa.m3_sub(soa.m3_mul(Bt, Ei), soa.m3_mul(C, U))
        W22 = soa.m3_mul(C, Ei)
        Y11 = soa.m3_sub(soa.m3T_mul(Ei, W11), soa.m3T_mul(U, W21))
        Y12 = soa.m3_sub(soa.m3T_mul(Ei, W12), soa.m3T_mul(U, W22))
        Y22 = soa.m3T_mul(Ei, W22)
        p = model.parent[i]
        Ic[p] = [
            soa.m3_add(Ic[p][0], Y11),
            soa.m3_add(Ic[p][1], Y12),
            soa.m3_add(Ic[p][2], Y22),
        ]

    # Lower-triangular M entries (dof order: base 0:6, then joints in
    # body order — dof index of body i is 6 + joint_of_body[i], and an
    # ancestor's dof index is always smaller).
    M = [[None] * (i + 1) for i in range(nv)]
    A0, B0, C0 = Ic[0]
    base66 = [
        [A0[0], A0[1], A0[2], B0[0], B0[1], B0[2]],
        [A0[3], A0[4], A0[5], B0[3], B0[4], B0[5]],
        [A0[6], A0[7], A0[8], B0[6], B0[7], B0[8]],
        [B0[0], B0[3], B0[6], C0[0], C0[1], C0[2]],
        [B0[1], B0[4], B0[7], C0[3], C0[4], C0[5]],
        [B0[2], B0[5], B0[8], C0[6], C0[7], C0[8]],
    ]
    for i in range(6):
        for j in range(i + 1):
            M[i][j] = base66[i][j]

    for i in range(1, NB):
        di = 6 + joint_of_body[i]
        axis = _const3(model.joint_axis[i])
        A, B, C = Ic[i]
        Bt = soa.m3_transpose(B)
        F = soa.sp(soa.m3_vec(A, axis), soa.m3_vec(Bt, axis))
        M[di][di] = soa.v3_dot(soa.sp_ang(F), axis)
        j = i
        while model.parent[j] >= 0:
            F = soa.xup_force_T(Rcp[j], jpos_c[j], F)
            j = model.parent[j]
            if model.joint_type[j] == FREE:
                for k in range(6):
                    M[di][k] = F[k]
            else:
                dj = 6 + joint_of_body[j]
                M[di][dj] = soa.v3_dot(
                    soa.sp_ang(F), _const3(model.joint_axis[j])
                )

    armature = np.asarray(model.armature, np.float64)
    damping = np.asarray(model.damping, np.float64)
    if mass_scale is not None:
        # Scalar density scale: CRBA is linear in the inertias, so
        # scale the assembled entries (one multiply per lower-tri
        # entry) instead of the per-body blocks.
        for i in range(nv):
            for j in range(i + 1):
                if M[i][j] is not None:
                    M[i][j] = M[i][j] * mass_scale
    dscale = 1.0 if damping_scale is None else damping_scale
    for k in range(nv):
        M[k][k] = M[k][k] + float(armature[k])
        if damping[k]:
            M[k][k] = M[k][k] + float(dt * damping[k]) * dscale

    # Unrolled Cholesky on the packed lower triangle (~nv³/6 fused
    # lane ops; nv = 18 for the quadruped class).
    L = [[None] * (i + 1) for i in range(nv)]
    for i in range(nv):
        for j in range(i + 1):
            # None = structural zero (dof pairs on different branches).
            s = aslane(0.0 if M[i][j] is None else M[i][j])
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return tuple(tuple(row) for row in L)


def substep_soa(model: Model, qpos, qvel, target, chol, kp: float, dt: float,
                *, terrain=None, terrain_planes=None, friction=None,
                mass_scale=None, damping_scale=None, gain_scale=None,
                push=None):
    """One physics substep on lane tuples.

    Args:
      model: static model (free base required; hinge joints).
      qpos: tuple of nq lanes ``(pos3, quat4, joints...)``.
      qvel: tuple of nv lanes ``(ω3 body, v3 body, joint rates...)``.
      target: tuple of nj lanes (PD position targets).
      chol: nested tuple ``chol[i][j]`` (i ≥ j) of lanes — lower
        Cholesky factor of ``M + dt·D`` (held constant over substeps).
      kp: PD P-gain (D-gain lives in model damping, implicit in chol).
      dt: substep length.
      terrain: optional analytic
        :class:`~portbench.reference.terrain.Terrain` heightfield
        (constants — each wave is a sin/cos per contact). ``None`` =
        flat z = 0 ground.
      terrain_planes: optional tuple of per-ground-geom ``(c, gx, gy)``
        lane triples — each geom's LOCAL tangent plane
        ``h(x, y) = c + gx·x + gy·y``, sampled from a data heightfield
        once per control step and held frozen over the substeps
        (:func:`heightgrid_planes_soa`). The contact model is
        already first-order in the
        surface at the sphere center, so freezing the tangent plane
        for one control step (~1-2 cm of foot travel) adds only the
        plane-vs-bilinear drift within that window — exact whenever
        the local surface IS a plane. Mutually exclusive with
        ``terrain``.
      friction / mass_scale / damping_scale / gain_scale: optional
        per-env domain-randomization lanes — the scalar
        :class:`DomainParams` fields
        (absolute friction coefficient; density, viscous-damping, and
        PD-gain multipliers). ``None`` = the Model constants, zero
        cost; ``gain_scale`` is the env-side ``gain · kp`` torque
        scaling.
      push: optional 3-lane tuple — a world-frame disturbance force at
        the base origin, the lane form of the env's
        ``external_forces=[(0, base_pos, f_push)]`` (moment arm zero
        about the base origin, so it lands purely on the linear base
        dofs in base coords).

    Returns ``(qpos', qvel')`` lane tuples.
    """
    assert model.free_base, "SoA substep supports free-base models"
    assert all(t in (FREE, HINGE) for t in model.joint_type), (
        "SoA substep supports hinge joints only; slide/ball-joint "
        "models need the generic engine, which is not ported yet"
    )
    assert terrain is None or terrain_planes is None, (
        "terrain and terrain_planes are mutually exclusive"
    )
    NB = model.n_bodies
    nj = model.nj
    nv = model.nv
    slices = model.dof_slices()

    pos = qpos[0:3]
    quat = qpos[3:7]
    jq = qpos[7:]
    w0 = qvel[0:3]
    v0 = qvel[3:6]
    jd = qvel[6:]

    # ---- kinematics (loop over bodies) ----
    E, P, Rcp, jpos_c, joint_of_body = _kin_soa(model, qpos)

    # ---- body velocities ----
    v = [None] * NB
    v[0] = soa.sp(w0, v0)
    for i in range(1, NB):
        parent = model.parent[i]
        vi = soa.xup_motion(Rcp[i], jpos_c[i], v[parent])
        axis = _const3(model.joint_axis[i])
        qd_i = jd[joint_of_body[i]]
        vi = (
            vi[0] + axis[0] * qd_i,
            vi[1] + axis[1] * qd_i,
            vi[2] + axis[2] * qd_i,
            vi[3], vi[4], vi[5],
        )
        v[i] = vi

    # ---- RNEA bias (gravity as upward world acceleration) ----
    lane = pos[0]
    zero = torch.zeros_like(lane)
    g = -float(model.gravity)  # +9.81
    a_world = (zero, zero, zero, zero, zero, zero + g)
    a = [None] * NB
    f = [None] * NB
    # Base: X0 = motion_transform(E0ᵀ, pos); crm(v)·v = 0.
    E0T = (
        E[0][0], E[0][3], E[0][6],
        E[0][1], E[0][4], E[0][7],
        E[0][2], E[0][5], E[0][8],
    )
    a[0] = soa.xup_motion(E0T, pos, a_world)
    for i in range(1, NB):
        parent = model.parent[i]
        ai = soa.xup_motion(Rcp[i], jpos_c[i], a[parent])
        axis = _const3(model.joint_axis[i])
        qd_i = jd[joint_of_body[i]]
        vj = (axis[0] * qd_i, axis[1] * qd_i, axis[2] * qd_i, zero, zero, zero)
        ai = soa.sp_add(ai, soa.crm_apply(v[i], vj))
        a[i] = ai
    for i in range(NB):
        mass = float(model.mass[i])
        com = _const3(model.com[i])
        Icom = _const9(model.inertia[i])
        Iv = soa.inertia_apply(mass, com, Icom, v[i])
        Ia = soa.inertia_apply(mass, com, Icom, a[i])
        f[i] = soa.sp_add(Ia, soa.crf_apply(v[i], Iv))
        if mass_scale is not None:
            # Density scale: I[i] → s·I[i] distributes over the whole
            # inertial wrench (both the I·a and crf(v)·I·v terms).
            f[i] = tuple(mass_scale * x for x in f[i])

    # ---- contacts (accumulate per body, then shared backward pass) ----
    mu = model.friction if friction is None else friction
    normals = []
    for gidx, b in enumerate(model.geom_body):
        offset = _const3(model.geom_offset[gidx])
        radius = float(model.geom_radius[gidx])
        E_b, P_b = E[b], P[b]
        x_w = soa.v3_add(P_b, soa.m3_vec(E_b, offset))
        wb = soa.sp_ang(v[b])
        lb = soa.sp_lin(v[b])
        if terrain is None and terrain_planes is None:
            # Flat-plane fast path: the normal is the constant +z, so
            # the normal/tangential split is a static index pick.
            phi = radius - x_w[2]
            down = soa.m3T_vec(E_b, (zero, zero, zero - 1.0))
            contact_offset = (
                offset[0] + down[0] * radius,
                offset[1] + down[1] * radius,
                offset[2] + down[2] * radius,
            )
            v_pt = soa.m3_vec(
                E_b, soa.v3_add(lb, soa.v3_cross(wb, contact_offset))
            )
            vn = v_pt[2]
        else:
            if terrain_planes is not None:
                # Per-geom frozen tangent plane (data terrain as lanes):
                # h(x, y) = c + gx·x + gy·y, normal from the constant
                # gradient — exactly the analytic branch below with the
                # wave sum replaced by three input lanes.
                c_g, gx_g, gy_g = terrain_planes[gidx]
                h = c_g + gx_g * x_w[0] + gy_g * x_w[1]
                inv = 1.0 / torch.sqrt(gx_g**2 + gy_g**2 + 1.0)
                n = (-gx_g * inv, -gy_g * inv, inv)
            else:
                # Analytic heightfield: surface normal from the exact
                # gradient at the center's xy; gap along n ≈ vertical
                # gap · n_z; contact point one radius down the normal.
                n = _terrain_normal_soa(terrain, x_w[0], x_w[1])
                h = _terrain_height_soa(terrain, x_w[0], x_w[1])
            phi = radius - (x_w[2] - h) * n[2]
            down_n = soa.m3T_vec(E_b, soa.v3_scale(-radius, n))
            contact_offset = soa.v3_add(offset, down_n)
            v_pt = soa.m3_vec(
                E_b, soa.v3_add(lb, soa.v3_cross(wb, contact_offset))
            )
            vn = soa.v3_dot(n, v_pt)
        active = phi > 0.0
        fn = torch.where(
            active,
            torch.clamp(
                model.contact_stiffness * phi - model.contact_damping * vn,
                min=0.0,
            ),
            0.0,
        )
        if np.isfinite(model.max_contact_force):
            fn = torch.clamp(fn, max=model.max_contact_force)
        if terrain is None and terrain_planes is None:
            vt_norm = torch.sqrt(v_pt[0] ** 2 + v_pt[1] ** 2 + 1e-6)
            scale = -mu * fn / torch.clamp(vt_norm, min=model.friction_vel)
            f_w = (scale * v_pt[0], scale * v_pt[1], fn)
        else:
            vt = soa.v3_sub(v_pt, soa.v3_scale(vn, n))
            vt_norm = torch.sqrt(soa.v3_dot(vt, vt) + 1e-6)
            scale = -mu * fn / torch.clamp(vt_norm, min=model.friction_vel)
            f_w = soa.v3_add(soa.v3_scale(fn, n), soa.v3_scale(scale, vt))
        normals.append(fn)
        f_b = soa.m3T_vec(E_b, f_w)
        f_sp = soa.sp(soa.v3_cross(contact_offset, f_b), f_b)
        # Subtract from the bias force (C enters the rhs negatively, so
        # external forces SUBTRACT from f): rhs = tau + tau_c - C.
        # Keep separate accumulation to mirror the engine exactly.
        f[b] = tuple(f[b][k] - f_sp[k] for k in range(6))

    # ---- sphere-sphere collision pairs (static list) ----
    # Same spring-damper normal + smooth-Coulomb friction as the ground
    # contacts, equal-and-opposite at the midpoint of the penetration
    # axis (momentum-conserving). Normals are appended after the
    # ground-geom normals.
    for ga, gb in zip(model.pair_geom_a, model.pair_geom_b):
        ba, bb = int(model.geom_body[ga]), int(model.geom_body[gb])
        ra = float(model.geom_radius[ga])
        rb = float(model.geom_radius[gb])
        xa = soa.v3_add(
            P[ba], soa.m3_vec(E[ba], _const3(model.geom_offset[ga]))
        )
        xb = soa.v3_add(
            P[bb], soa.m3_vec(E[bb], _const3(model.geom_offset[gb]))
        )
        d = soa.v3_sub(xb, xa)
        dist = torch.sqrt(soa.v3_dot(d, d) + 1e-12)
        n = soa.v3_scale(1.0 / dist, d)  # contact normal, a → b
        phi = ra + rb - dist
        c_w = soa.v3_add(xa, soa.v3_scale(ra - 0.5 * phi, n))

        def _point_vel(b, c):
            r_loc = soa.m3T_vec(E[b], soa.v3_sub(c, P[b]))
            wb, lb = soa.sp_ang(v[b]), soa.sp_lin(v[b])
            return soa.m3_vec(
                E[b], soa.v3_add(lb, soa.v3_cross(wb, r_loc))
            )

        v_rel = soa.v3_sub(_point_vel(bb, c_w), _point_vel(ba, c_w))
        sep = soa.v3_dot(n, v_rel)  # separation rate (= -φ̇)
        fn = torch.where(
            phi > 0.0,
            torch.clamp(
                model.contact_stiffness * phi - model.contact_damping * sep,
                min=0.0,
            ),
            0.0,
        )
        if np.isfinite(model.max_contact_force):
            fn = torch.clamp(fn, max=model.max_contact_force)
        vt = soa.v3_sub(v_rel, soa.v3_scale(sep, n))
        vt_norm = torch.sqrt(soa.v3_dot(vt, vt) + 1e-6)
        ft_scale = -mu * fn / torch.clamp(vt_norm, min=model.friction_vel)
        f_w = soa.v3_add(soa.v3_scale(fn, n), soa.v3_scale(ft_scale, vt))
        normals.append(fn)
        for b, sign in ((bb, 1.0), (ba, -1.0)):
            r_loc = soa.m3T_vec(E[b], soa.v3_sub(c_w, P[b]))
            f_b = soa.m3T_vec(E[b], soa.v3_scale(sign, f_w))
            f_sp = soa.sp(soa.v3_cross(r_loc, f_b), f_b)
            f[b] = tuple(f[b][k] - f_sp[k] for k in range(6))

    # ---- backward pass: generalized bias (incl. contacts) ----
    per_dof = [None] * NB
    for i in reversed(range(NB)):
        if model.joint_type[i] == FREE:
            per_dof[i] = list(f[i])  # S = I6
        else:
            axis = _const3(model.joint_axis[i])
            per_dof[i] = [
                axis[0] * f[i][0] + axis[1] * f[i][1] + axis[2] * f[i][2]
            ]
        parent = model.parent[i]
        if parent >= 0:
            up = soa.xup_force_T(Rcp[i], jpos_c[i], f[i])
            f[parent] = soa.sp_add(f[parent], up)

    C = []
    for i in range(NB):
        C.extend(per_dof[i])
    damping = [float(d) for d in model.damping]
    dscale = 1.0 if damping_scale is None else damping_scale
    C = [
        C[k] + (damping[k] * dscale) * qvel[k] if damping[k] else C[k]
        for k in range(nv)
    ]

    # ---- applied torques (per-substep PD, P-term only) ----
    gain = kp if gain_scale is None else gain_scale * kp
    rhs = [-C[k] for k in range(6)]
    for j in range(nj):
        rhs.append(gain * (target[j] - jq[j]) - C[6 + j])

    # ---- joint-range limits ----
    # Spring-damper on the violation, damping active only while
    # violating; applied AFTER the PD/bias assembly and BEFORE springs.
    if model.joint_lower.size > 0:
        for j in range(nj):
            lo = float(model.joint_lower[6 + j])
            hi = float(model.joint_upper[6 + j])
            if not (np.isfinite(lo) or np.isfinite(hi)):
                continue
            q_j, qd_j = jq[j], jd[j]
            below = torch.clamp(lo - q_j, min=0.0) if np.isfinite(lo) else 0.0
            above = torch.clamp(q_j - hi, min=0.0) if np.isfinite(hi) else 0.0
            violating = ((below + above) > 0.0).to(q_j.dtype)
            rhs[6 + j] = rhs[6 + j] + (
                model.limit_stiffness * (below - above)
                - model.limit_damping * violating * qd_j
            )

    # ---- passive joint springs ----
    if model.spring_stiffness.size > 0:
        for j in range(nj):
            k_s = float(model.spring_stiffness[6 + j])
            if k_s <= 0.0:
                continue
            ref = float(model.spring_ref[6 + j])
            rhs[6 + j] = rhs[6 + j] - k_s * (jq[j] - ref)

    # ---- external push (world force at the base origin) ----
    # The one force the envs apply: point = base origin ⇒ zero moment
    # arm, so the wrench is (0, E₀ᵀ f_w) on the free joint's linear
    # dofs. Added after limits/springs.
    if push is not None:
        f_b = soa.m3T_vec(E[0], push)
        for k in range(3):
            rhs[3 + k] = rhs[3 + k] + f_b[k]

    # ---- back-substitution with the held factor ----
    ys = []
    for i in range(nv):
        acc = rhs[i]
        for k in range(i):
            acc = acc - chol[i][k] * ys[k]
        ys.append(acc / chol[i][i])
    qacc = [None] * nv
    for i in reversed(range(nv)):
        acc = ys[i]
        for k in range(i + 1, nv):
            acc = acc - chol[k][i] * qacc[k]
        qacc[i] = acc / chol[i][i]

    # ---- semi-implicit Euler ----
    new_qvel = tuple(qvel[k] + dt * qacc[k] for k in range(nv))
    w_new = new_qvel[0:3]
    v_new = new_qvel[3:6]
    pos_new = soa.v3_add(pos, soa.v3_scale(dt, soa.m3_vec(E[0], v_new)))
    quat_new = soa.quat_integrate(quat, w_new, dt)
    jq_new = tuple(jq[j] + dt * new_qvel[6 + j] for j in range(nj))
    new_qpos = pos_new + quat_new + jq_new
    return new_qpos, new_qvel, tuple(normals)
