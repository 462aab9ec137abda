"""General-tree SoA dynamics: the plain PyTorch version of the scene
control-step kernel.

Port of ``nnx_ppo_tpu/physics/engine_soa_general.py`` (every function,
same names): the lane form of the generic engine's forward dynamics and
integration, and of the scene layer's cross-tree coupling, for the
manipulation workload class: rooted trees, BALL and SLIDE joints, free
rigid bodies, and multi-tree scenes with cross-tree sphere contacts.

Every scalar of the computation is a ``[B]`` lane (see ``soa.py``) and
the model's constants are Python floats, so the functions below are the
JAX functions with ``jnp`` replaced by ``torch``: same math, same order
of operations. Joint types enter through per-joint motion-subspace
columns that are Python constants; zero entries, identity rotations and
the world frame are pruned while the expression is built
(``_sdot``, ``_s_times``, ``_m3_mul_c``, ``_m3_vec_c``, ``_v3_add_c``,
``_m3T_mul_c``), which fixes which float32 operations exist. The CUDA
kernel (``csrc/scene_step.cu``) loops at run time instead; it repeats the
operations that change a value and is held to this version on the card
(``cuda_scene_step.py``).

Semantics: exact dynamics per substep. The CRBA factor of
``M(q) + armature + dt·D`` is rebuilt from the current ``qpos`` at every
substep, as ``engine.forward_dynamics`` with ``chol=None`` does in the
JAX package (what ``engine.step`` and ``scene.scene_step``, the
manipulation envs' reference step functions, use).
"""

from __future__ import annotations

import numpy as np
import torch

from nnx_ppo_tpu_torch.physics import soa
from nnx_ppo_tpu_torch.physics.engine_soa import (
    _const3,
    _terrain_height_soa,
    _terrain_normal_soa,
)
from nnx_ppo_tpu_torch.physics.model import BALL, FREE, HINGE, SLIDE, Model


def soa_general_unsupported_reason(model: Model) -> "str | None":
    """Why the general SoA path cannot run this model — ``None`` if it
    can. Broader than ``engine_soa.soa_unsupported_reason``: any tree
    of FREE (at a root) / BALL / HINGE / SLIDE joints qualifies."""
    for i, t in enumerate(model.joint_type):
        if t == FREE and model.parent[i] >= 0:
            return "FREE joints are supported at tree roots only"
        if t not in (FREE, BALL, HINGE, SLIDE):
            return f"unsupported joint type {t!r}"
    return None


# ---------------------------------------------------------------- S cols


def _s_cols(model: Model, i: int):
    """Motion-subspace columns of joint i as constant 6-tuples
    (child-frame; Featherstone convention, angular first)."""
    t = model.joint_type[i]
    if t == FREE:
        return [tuple(1.0 if k == c else 0.0 for k in range(6))
                for c in range(6)]
    if t == BALL:
        return [tuple(1.0 if k == c else 0.0 for k in range(6))
                for c in range(3)]
    ax = _const3(model.joint_axis[i])
    if t == HINGE:
        return [(ax[0], ax[1], ax[2], 0.0, 0.0, 0.0)]
    return [(0.0, 0.0, 0.0, ax[0], ax[1], ax[2])]  # SLIDE


def _sdot(col, f):
    """``colᵀ f`` with trace-time zero pruning (col: float 6-tuple,
    f: 6-tuple of lanes)."""
    acc = None
    for k in range(6):
        c = col[k]
        if c == 0.0:
            continue
        term = f[k] if c == 1.0 else c * f[k]
        acc = term if acc is None else acc + term
    return acc


def _s_times(cols, qds, zero):
    """``S @ qd`` → 6-tuple of lanes (zeros pruned at trace time)."""
    out = [None] * 6
    for col, qd in zip(cols, qds):
        for k in range(6):
            c = col[k]
            if c == 0.0:
                continue
            term = qd if c == 1.0 else c * qd
            out[k] = term if out[k] is None else out[k] + term
    return tuple(zero if o is None else o for o in out)


# ------------------------------------------------------------ kinematics


def kin_soa_g(model: Model, qpos):
    """Per-body lane kinematics for a general tree.

    Returns ``(E, P, Rcp, r, qd_slices)`` where ``E``/``P`` are world
    rotation (9 lanes) / origin (3 lanes) per body, and ``(Rcp, r)``
    define the body's motion transform from its parent frame
    (``child_R_parent``, child origin in parent coords — ``r`` is
    lane-valued for SLIDE joints, the world pose for FREE roots).
    """
    NB = model.n_bodies
    qslices = model.qpos_slices()
    E = [None] * NB
    P = [None] * NB
    Rcp = [None] * NB
    r = [None] * NB
    for i, jtype in enumerate(model.joint_type):
        parent = model.parent[i]
        qs, nqi = qslices[i]
        jp = _const3(model.joint_pos[i])
        if jtype == FREE:
            pos = qpos[qs:qs + 3]
            quat = qpos[qs + 3:qs + 7]
            E[i] = soa.quat_to_m3(quat)
            P[i] = pos
            Rcp[i] = soa.m3_transpose(E[i])
            r[i] = pos
            continue
        if parent < 0:
            # World frame: constant identity/origin, pruned at trace
            # time by the _*_c helpers below.
            E_par = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
            P_par = (0.0, 0.0, 0.0)
        else:
            E_par, P_par = E[parent], P[parent]
        if jtype == BALL:
            R_j = soa.quat_to_m3(qpos[qs:qs + 4])  # parent_R_child
            Rcp[i] = soa.m3_transpose(R_j)
            r[i] = jp
        elif jtype == HINGE:
            axis = _const3(model.joint_axis[i])
            R_j = soa.axis_angle_m3(axis, qpos[qs])
            Rcp[i] = soa.m3_transpose(R_j)
            r[i] = jp
        else:  # SLIDE
            axis = _const3(model.joint_axis[i])
            q = qpos[qs]
            R_j = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
            Rcp[i] = R_j
            r[i] = (jp[0] + axis[0] * q, jp[1] + axis[1] * q,
                    jp[2] + axis[2] * q)
        E[i] = _m3_mul_c(E_par, R_j)
        P[i] = _v3_add_c(P_par, _m3_vec_c(E_par, r[i]))
    return E, P, Rcp, r


def _m3_mul_c(A, B):
    """m3_mul tolerating python-float (constant) matrix entries."""
    if all(isinstance(a, float) for a in A):
        if A == (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0):
            return B
    if all(isinstance(b, float) for b in B):
        if B == (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0):
            return A
    return soa.m3_mul(A, B)


def _m3_vec_c(M, v):
    if all(isinstance(a, float) for a in M):
        if M == (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0):
            return v
    return soa.m3_vec(M, v)


def _v3_add_c(a, b):
    if all(isinstance(x, float) for x in a) and a == (0.0, 0.0, 0.0):
        return b
    return soa.v3_add(a, b)


# ---------------------------------------------------------------- forces


def vel_soa_g(model: Model, kin, qvel):
    """Per-body spatial velocities (body frame)."""
    E, P, Rcp, r = kin
    zero = torch.zeros_like(qvel[0])
    v = [None] * model.n_bodies
    for i, (vs, nd) in enumerate(model.dof_slices()):
        cols = _s_cols(model, i)
        vj = _s_times(cols, [qvel[vs + k] for k in range(nd)], zero)
        parent = model.parent[i]
        if parent < 0:
            v[i] = vj
        else:
            v[i] = soa.sp_add(soa.xup_motion(Rcp[i], r[i], v[parent]), vj)
    return v


def _const_blocks(model: Model, i: int):
    """Body spatial inertia as (A, B, C) 3×3 float blocks (row-major
    9-tuples): ``[[A, B], [Bᵀ, C]]``."""
    m = float(model.mass[i])
    c = np.asarray(model.com[i], np.float64)
    cx = np.array([[0.0, -c[2], c[1]],
                   [c[2], 0.0, -c[0]],
                   [-c[1], c[0], 0.0]])
    I6 = np.block([
        [np.asarray(model.inertia[i], np.float64) + m * cx @ cx.T, m * cx],
        [m * cx.T, m * np.eye(3)],
    ])
    blk = lambda rr, cc: tuple(
        float(x) for x in I6[rr:rr + 3, cc:cc + 3].reshape(-1)
    )
    return [blk(0, 0), blk(0, 3), blk(3, 3)]


def _blocks_times_sp(blocks, v):
    """``[[A, B], [Bᵀ, C]] @ v`` for (possibly lane-valued) blocks."""
    A, B, C = blocks
    Bt = soa.m3_transpose(B)
    w, l = soa.sp_ang(v), soa.sp_lin(v)
    return soa.sp(
        soa.v3_add(soa.m3_vec(A, w), soa.m3_vec(B, l)),
        soa.v3_add(soa.m3_vec(Bt, w), soa.m3_vec(C, l)),
    )


def crba_chol_soa_g(model: Model, kin, dt: float):
    """General CRBA + unrolled Cholesky of ``M + armature + dt·D`` on
    lanes (the in-kernel factor for arbitrary trees; lane form of
    ``engine.mass_matrix_factor``)."""
    NB = model.n_bodies
    nv = model.nv
    E, P, Rcp, r = kin
    lane = next(x for Ei in E for x in Ei if torch.is_tensor(x))

    Ic = [_const_blocks(model, i) for i in range(NB)]
    for i in reversed(range(NB)):
        p = model.parent[i]
        if p < 0:
            continue
        # Congruence Y = X_upᵀ Ic X_up, X = [[R, 0], [-U, R]],
        # R = child_R_parent, U = R·skew(r).
        Ri = Rcp[i]
        rr = r[i]
        sk = (0.0, -rr[2], rr[1],
              rr[2], 0.0, -rr[0],
              -rr[1], rr[0], 0.0)
        U = _m3_mul_c(Ri, sk)
        A, B, C = Ic[i]
        Bt = soa.m3_transpose(B)
        W11 = soa.m3_sub(_m3_mul_c(A, Ri), _m3_mul_c(B, U))
        W12 = _m3_mul_c(B, Ri)
        W21 = soa.m3_sub(_m3_mul_c(Bt, Ri), _m3_mul_c(C, U))
        W22 = _m3_mul_c(C, Ri)
        Y11 = soa.m3_sub(_m3T_mul_c(Ri, W11), _m3T_mul_c(U, W21))
        Y12 = soa.m3_sub(_m3T_mul_c(Ri, W12), _m3T_mul_c(U, W22))
        Y22 = _m3T_mul_c(Ri, W22)
        Ic[p] = [
            soa.m3_add(Ic[p][0], Y11),
            soa.m3_add(Ic[p][1], Y12),
            soa.m3_add(Ic[p][2], Y22),
        ]

    slices = model.dof_slices()
    M = [[None] * (i + 1) for i in range(nv)]
    for i in range(NB):
        si, ni = slices[i]
        cols = _s_cols(model, i)
        for a in range(ni):
            F = _blocks_times_sp(Ic[i], _col_sp(cols[a]))
            # Diagonal block (lower half).
            for b in range(a + 1):
                M[si + a][si + b] = _sdot(cols[b], F)
            j = i
            while model.parent[j] >= 0:
                F = soa.xup_force_T(Rcp[j], r[j], F)
                j = model.parent[j]
                sj, nj_ = slices[j]
                jcols = _s_cols(model, j)
                for b in range(nj_):
                    M[si + a][sj + b] = _sdot(jcols[b], F)

    armature = np.asarray(model.armature, np.float64)
    damping = np.asarray(model.damping, np.float64)

    def aslane(x):
        return x if torch.is_tensor(x) else torch.full_like(lane, x)

    for k in range(nv):
        M[k][k] = M[k][k] + float(armature[k])
        if damping[k]:
            M[k][k] = M[k][k] + float(dt * damping[k])

    L = [[None] * (i + 1) for i in range(nv)]
    for i in range(nv):
        for j in range(i + 1):
            s = aslane(0.0 if M[i][j] is None else M[i][j])
            for k in range(j):
                if L[i][k] is None or L[j][k] is None:
                    continue
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return tuple(tuple(row) for row in L)


def _col_sp(col):
    """A constant S column as a float spatial 6-tuple."""
    return col


def _m3T_mul_c(A, B):
    if all(isinstance(a, float) for a in A):
        if A == (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0):
            return B
    return soa.m3T_mul(A, B)


# --------------------------------------------------------------- dynamics


def dynamics_soa_g(model: Model, kin, v, qpos, qvel, tau, chol, dt: float,
                   *, terrain=None, ext_forces=()):
    """Generalized acceleration + contact normals for one tree (lane
    form of ``engine.forward_dynamics``): RNEA bias → ground/pair
    penalty contacts → limits/springs → external (cross-tree) point
    forces → back-substitution with ``chol``.

    ``ext_forces``: sequence of ``(body, point_world, f_world)`` lane
    entries (the scene layer's cross-tree contact forces).
    Returns ``(qacc [nv lanes], normals list)``.
    """
    E, P, Rcp, r = kin
    NB = model.n_bodies
    nv = model.nv
    slices = model.dof_slices()
    qslices = model.qpos_slices()
    zero = torch.zeros_like(qvel[0])

    # ---- RNEA bias (gravity as upward world acceleration) ----
    g = -float(model.gravity)
    a_world = (0.0, 0.0, 0.0, 0.0, 0.0, g)
    a = [None] * NB
    f = [None] * NB
    for i, (vs, nd) in enumerate(slices):
        cols = _s_cols(model, i)
        vj = _s_times(cols, [qvel[vs + k] for k in range(nd)], zero)
        parent = model.parent[i]
        a_par = a_world if parent < 0 else a[parent]
        ai = soa.xup_motion(Rcp[i], r[i], a_par)
        ai = soa.sp_add(ai, soa.crm_apply(v[i], vj))
        a[i] = ai
        mass = float(model.mass[i])
        com = _const3(model.com[i])
        Icom = tuple(float(x) for x in np.asarray(
            model.inertia[i], np.float64).reshape(-1))
        Iv = soa.inertia_apply(mass, com, Icom, v[i])
        Ia = soa.inertia_apply(mass, com, Icom, a[i])
        f[i] = soa.sp_add(Ia, soa.crf_apply(v[i], Iv))

    # ---- penalty contacts: ground geoms ----
    mu = model.friction
    normals = []
    for gidx, b in enumerate(model.geom_body):
        offset = _const3(model.geom_offset[gidx])
        radius = float(model.geom_radius[gidx])
        E_b, P_b = E[b], P[b]
        x_w = soa.v3_add(P_b, soa.m3_vec(E_b, offset))
        wb = soa.sp_ang(v[b])
        lb = soa.sp_lin(v[b])
        if terrain is None:
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
            # A geom whose world xy is a constant (a body fixed in the
            # world frame) still samples the terrain on lanes.
            x_t, y_t = zero + x_w[0], zero + x_w[1]
            n = _terrain_normal_soa(terrain, x_t, y_t)
            h = _terrain_height_soa(terrain, x_t, y_t)
            phi = radius - (x_w[2] - h) * n[2]
            down_n = soa.m3T_vec(E_b, soa.v3_scale(-radius, n))
            contact_offset = soa.v3_add(offset, down_n)
            v_pt = soa.m3_vec(
                E_b, soa.v3_add(lb, soa.v3_cross(wb, contact_offset))
            )
            vn = soa.v3_dot(n, v_pt)
        if not torch.is_tensor(phi):
            phi = zero + phi  # a geom at a constant height
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
        if terrain is None:
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
        f[b] = tuple(f[b][k] - f_sp[k] for k in range(6))

    # ---- intra-tree sphere-sphere pairs ----
    for ga, gb in zip(model.pair_geom_a, model.pair_geom_b):
        fn, c_w, f_w = _sphere_pair_soa(
            model, model, kin, kin, v, v, ga, gb
        )
        _accumulate_point_force(kin, f, int(model.geom_body[gb]), c_w, f_w, 1.0)
        _accumulate_point_force(kin, f, int(model.geom_body[ga]), c_w, f_w, -1.0)
        normals.append(fn)

    # ---- external (cross-tree) world point forces ----
    for b, c_w, f_w in ext_forces:
        _accumulate_point_force(kin, f, b, c_w, f_w, 1.0)

    # ---- backward pass: generalized bias ----
    per_dof = [None] * NB
    for i in reversed(range(NB)):
        cols = _s_cols(model, i)
        per_dof[i] = [_sdot(col, f[i]) for col in cols]
        parent = model.parent[i]
        if parent >= 0:
            up = soa.xup_force_T(Rcp[i], r[i], f[i])
            f[parent] = soa.sp_add(f[parent], up)
    C = []
    for i in range(NB):
        C.extend(per_dof[i])
    damping = [float(d) for d in model.damping]
    C = [
        C[k] + damping[k] * qvel[k] if damping[k] else C[k]
        for k in range(nv)
    ]

    rhs = [tau[k] - C[k] for k in range(nv)]

    # ---- joint-range limits (1-dof joints) ----
    if model.joint_lower.size > 0:
        for i, jtype in enumerate(model.joint_type):
            if jtype not in (HINGE, SLIDE):
                continue
            (vs, _), (qs, _) = slices[i], qslices[i]
            lo = float(model.joint_lower[vs])
            hi = float(model.joint_upper[vs])
            if not (np.isfinite(lo) or np.isfinite(hi)):
                continue
            q_j, qd_j = qpos[qs], qvel[vs]
            below = torch.clamp(lo - q_j, min=0.0) if np.isfinite(lo) else 0.0
            above = torch.clamp(q_j - hi, min=0.0) if np.isfinite(hi) else 0.0
            violating = ((below + above) > 0.0).to(q_j.dtype)
            rhs[vs] = rhs[vs] + (
                model.limit_stiffness * (below - above)
                - model.limit_damping * violating * qd_j
            )

    # ---- passive joint springs (1-dof joints) ----
    if model.spring_stiffness.size > 0:
        for i, jtype in enumerate(model.joint_type):
            if jtype not in (HINGE, SLIDE):
                continue
            (vs, _), (qs, _) = slices[i], qslices[i]
            k_s = float(model.spring_stiffness[vs])
            if k_s <= 0.0:
                continue
            ref = float(model.spring_ref[vs])
            rhs[vs] = rhs[vs] - k_s * (qpos[qs] - ref)

    # ---- solve with the factor ----
    ys = []
    for i in range(nv):
        acc = rhs[i]
        for k in range(i):
            if chol[i][k] is None:
                continue
            acc = acc - chol[i][k] * ys[k]
        ys.append(acc / chol[i][i])
    qacc = [None] * nv
    for i in reversed(range(nv)):
        acc = ys[i]
        for k in range(i + 1, nv):
            if chol[k][i] is None:
                continue
            acc = acc - chol[k][i] * qacc[k]
        qacc[i] = acc / chol[i][i]
    return qacc, normals


def _sphere_pair_soa(ma, mb, kin_a, kin_b, va, vb, ga, gb):
    """Sphere-sphere penalty pair between geom ``ga`` of tree a and
    ``gb`` of tree b (a may equal b for intra-tree pairs): equal and
    opposite at the midpoint of the penetration axis. Returns
    ``(fn, c_w, f_w)`` — normal-force lane, world contact point, world
    force ON b (a feels ``-f_w``). Cross-tree parameters are the
    arithmetic means (``scene.py``)."""
    Ea, Pa, _, _ = kin_a
    Eb, Pb, _, _ = kin_b
    ba, bb_ = int(ma.geom_body[ga]), int(mb.geom_body[gb])
    ra = float(ma.geom_radius[ga])
    rb = float(mb.geom_radius[gb])
    xa = soa.v3_add(Pa[ba], soa.m3_vec(Ea[ba], _const3(ma.geom_offset[ga])))
    xb = soa.v3_add(Pb[bb_], soa.m3_vec(Eb[bb_], _const3(mb.geom_offset[gb])))
    d = soa.v3_sub(xb, xa)
    dist = torch.sqrt(soa.v3_dot(d, d) + 1e-12)
    n = soa.v3_scale(1.0 / dist, d)  # a → b
    phi = ra + rb - dist
    c_w = soa.v3_add(xa, soa.v3_scale(ra - 0.5 * phi, n))

    def point_vel(kin, v, b, c):
        E, P, _, _ = kin
        r_loc = soa.m3T_vec(E[b], soa.v3_sub(c, P[b]))
        w, l = soa.sp_ang(v[b]), soa.sp_lin(v[b])
        return soa.m3_vec(E[b], soa.v3_add(l, soa.v3_cross(w, r_loc)))

    v_rel = soa.v3_sub(
        point_vel(kin_b, vb, bb_, c_w), point_vel(kin_a, va, ba, c_w)
    )
    sep = soa.v3_dot(n, v_rel)
    stiffness = 0.5 * (ma.contact_stiffness + mb.contact_stiffness)
    damping = 0.5 * (ma.contact_damping + mb.contact_damping)
    friction = 0.5 * (ma.friction + mb.friction)
    friction_vel = max(ma.friction_vel, mb.friction_vel)
    max_force = min(ma.max_contact_force, mb.max_contact_force)
    fn = torch.where(
        phi > 0.0,
        torch.clamp(stiffness * phi - damping * sep, min=0.0),
        0.0,
    )
    if np.isfinite(max_force):
        fn = torch.clamp(fn, max=max_force)
    vt = soa.v3_sub(v_rel, soa.v3_scale(sep, n))
    vt_norm = torch.sqrt(soa.v3_dot(vt, vt) + 1e-6)
    ft_scale = -friction * fn / torch.clamp(vt_norm, min=friction_vel)
    f_w = soa.v3_add(soa.v3_scale(fn, n), soa.v3_scale(ft_scale, vt))
    return fn, c_w, f_w


def _accumulate_point_force(kin, flist, b, c_w, f_w, sign):
    """Fold a world point force into a body's bias-force accumulator
    (contacts SUBTRACT from f so rhs = tau − C carries them
    positively)."""
    E, P, _, _ = kin
    r_loc = soa.m3T_vec(E[b], soa.v3_sub(c_w, P[b]))
    f_bdy = soa.m3T_vec(E[b], soa.v3_scale(sign, f_w))
    f_sp = soa.sp(soa.v3_cross(r_loc, f_bdy), f_bdy)
    flist[b] = tuple(flist[b][k] - f_sp[k] for k in range(6))


# -------------------------------------------------------------- integrate


def integrate_soa_g(model: Model, qpos, qvel_new, dt: float, kin=None):
    """Semi-implicit Euler on lanes for general trees (lane form of
    ``engine.integrate``: FREE positions advance with the PRE-update
    orientation; quaternion joints use the exponential map)."""
    qslices = model.qpos_slices()
    vslices = model.dof_slices()
    new_q = []
    for i, jtype in enumerate(model.joint_type):
        qs, nqi = qslices[i]
        vs, nvi = vslices[i]
        if jtype == FREE:
            pos = qpos[qs:qs + 3]
            quat = qpos[qs + 3:qs + 7]
            E = soa.quat_to_m3(quat)
            w_new = qvel_new[vs:vs + 3]
            v_new = qvel_new[vs + 3:vs + 6]
            pos_new = soa.v3_add(pos, soa.v3_scale(dt, soa.m3_vec(E, v_new)))
            new_q.extend(pos_new)
            new_q.extend(soa.quat_integrate(quat, w_new, dt))
        elif jtype == BALL:
            quat = qpos[qs:qs + 4]
            new_q.extend(soa.quat_integrate(quat, qvel_new[vs:vs + 3], dt))
        else:
            new_q.append(qpos[qs] + dt * qvel_new[vs])
    return tuple(new_q)


def substep_soa_g(model: Model, qpos, qvel, tau, dt: float, *, terrain=None,
                  ext_forces=()):
    """One exact-dynamics substep of a general tree on lanes: the lane
    form of ``engine.forward_dynamics`` (chol=None) + ``integrate``.
    Returns ``(qpos', qvel', normals)``."""
    kin = kin_soa_g(model, qpos)
    v = vel_soa_g(model, kin, qvel)
    chol = crba_chol_soa_g(model, kin, dt)
    qacc, normals = dynamics_soa_g(
        model, kin, v, qpos, qvel, tau, chol, dt,
        terrain=terrain, ext_forces=ext_forces,
    )
    qvel_new = tuple(qvel[k] + dt * qacc[k] for k in range(model.nv))
    qpos_new = integrate_soa_g(model, qpos, qvel_new, dt)
    return qpos_new, qvel_new, tuple(normals)


def scene_substep_soa(models, pairs, qposs, qvels, taus, dt: float,
                      terrain=None):
    """One exact-dynamics substep of a multi-tree scene on lanes — the
    lane form of ``scene.scene_forward`` + per-tree ``integrate``.

    ``pairs``: ``(tree_a, geom_a, tree_b, geom_b)`` cross-tree sphere
    contacts (``scene.Scene.pairs``). Returns
    ``(qposs', qvels', per-tree normals, cross-pair normals)``.
    """
    kins = [kin_soa_g(m, qp) for m, qp in zip(models, qposs)]
    vs = [vel_soa_g(m, k, qv) for m, k, qv in zip(models, kins, qvels)]

    # Cross-tree pair forces, handed to each tree's dynamics as
    # (body, point, force) ext triples — dynamics_soa_g folds them into
    # the bias accumulation with the same rule as intra-tree pairs.
    ext: list[list] = [[] for _ in models]
    cross_normals = []
    for ta, ga, tb, gb in pairs:
        fn, c_w, f_w = _sphere_pair_soa(
            models[ta], models[tb], kins[ta], kins[tb], vs[ta], vs[tb],
            ga, gb,
        )
        cross_normals.append(fn)
        ext[tb].append((int(models[tb].geom_body[gb]), c_w, f_w))
        ext[ta].append(
            (int(models[ta].geom_body[ga]), c_w, tuple(-x for x in f_w))
        )

    new_qposs, new_qvels, tree_normals = [], [], []
    for t, m in enumerate(models):
        chol = crba_chol_soa_g(m, kins[t], dt)
        qacc, normals = dynamics_soa_g(
            m, kins[t], vs[t], qposs[t], qvels[t], taus[t], chol, dt,
            terrain=terrain, ext_forces=ext[t],
        )
        qvel_new = tuple(qvels[t][k] + dt * qacc[k] for k in range(m.nv))
        new_qvels.append(qvel_new)
        new_qposs.append(integrate_soa_g(m, qposs[t], qvel_new, dt))
        tree_normals.append(tuple(normals))
    return (
        tuple(new_qposs),
        tuple(new_qvels),
        tuple(tree_normals),
        tuple(cross_normals),
    )
