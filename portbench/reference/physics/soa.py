"""Lane algebra of the reference physics: 3-vectors, 3x3 matrices,
quaternions and spatial vectors on tuples of ``[B]`` lanes (a frozen
copy of ``nnx_ppo_tpu_torch/physics/soa.py``)."""

from __future__ import annotations

import math

import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """``world_R_body`` of unit quaternions ``q[..., 4]`` (w, x, y, z) as
    ``[..., 3, 3]`` (``spatial.py::quat_to_rot``)."""
    m = quat_to_m3(q.unbind(-1))
    return torch.stack(m, dim=-1).reshape(q.shape[:-1] + (3, 3))


# -- vec3 ---------------------------------------------------------------


def v3(x, y, z):
    return (x, y, z)


def v3_zeros_like(lane):
    z = torch.zeros_like(lane)
    return (z, z, z)


def v3_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3_scale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


# -- mat3 (row-major 9-tuple) ------------------------------------------


def m3_identity(lane):
    one = torch.ones_like(lane)
    zero = torch.zeros_like(lane)
    return (one, zero, zero, zero, one, zero, zero, zero, one)


def m3_vec(M, v):
    """M @ v."""
    return (
        M[0] * v[0] + M[1] * v[1] + M[2] * v[2],
        M[3] * v[0] + M[4] * v[1] + M[5] * v[2],
        M[6] * v[0] + M[7] * v[1] + M[8] * v[2],
    )


def m3T_vec(M, v):
    """Mᵀ @ v."""
    return (
        M[0] * v[0] + M[3] * v[1] + M[6] * v[2],
        M[1] * v[0] + M[4] * v[1] + M[7] * v[2],
        M[2] * v[0] + M[5] * v[1] + M[8] * v[2],
    )


def m3_mul(A, B):
    """A @ B (both row-major 9-tuples)."""
    return (
        A[0] * B[0] + A[1] * B[3] + A[2] * B[6],
        A[0] * B[1] + A[1] * B[4] + A[2] * B[7],
        A[0] * B[2] + A[1] * B[5] + A[2] * B[8],
        A[3] * B[0] + A[4] * B[3] + A[5] * B[6],
        A[3] * B[1] + A[4] * B[4] + A[5] * B[7],
        A[3] * B[2] + A[4] * B[5] + A[5] * B[8],
        A[6] * B[0] + A[7] * B[3] + A[8] * B[6],
        A[6] * B[1] + A[7] * B[4] + A[8] * B[7],
        A[6] * B[2] + A[7] * B[5] + A[8] * B[8],
    )


def m3_add(A, B):
    return tuple(A[k] + B[k] for k in range(9))


def m3_sub(A, B):
    return tuple(A[k] - B[k] for k in range(9))


def m3_transpose(A):
    return (A[0], A[3], A[6], A[1], A[4], A[7], A[2], A[5], A[8])


def m3T_mul(A, B):
    """Aᵀ @ B (both row-major 9-tuples)."""
    return (
        A[0] * B[0] + A[3] * B[3] + A[6] * B[6],
        A[0] * B[1] + A[3] * B[4] + A[6] * B[7],
        A[0] * B[2] + A[3] * B[5] + A[6] * B[8],
        A[1] * B[0] + A[4] * B[3] + A[7] * B[6],
        A[1] * B[1] + A[4] * B[4] + A[7] * B[7],
        A[1] * B[2] + A[4] * B[5] + A[7] * B[8],
        A[2] * B[0] + A[5] * B[3] + A[8] * B[6],
        A[2] * B[1] + A[5] * B[4] + A[8] * B[7],
        A[2] * B[2] + A[5] * B[5] + A[8] * B[8],
    )


def quat_to_m3(q):
    """world_R_body of a unit quaternion (w, x, y, z) — same convention
    as ``spatial.quat_to_rot``."""
    w, x, y, z = q
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def axis_angle_m3(axis, angle):
    """Active rotation about a CONSTANT unit axis (python floats) by a
    per-lane angle (Rodrigues with the axis folded in as constants)."""
    ax, ay, az = float(axis[0]), float(axis[1]), float(axis[2])
    s, c = torch.sin(angle), torch.cos(angle)
    C = 1.0 - c
    return (
        c + ax * ax * C, ax * ay * C - az * s, ax * az * C + ay * s,
        ay * ax * C + az * s, c + ay * ay * C, ay * az * C - ax * s,
        az * ax * C - ay * s, az * ay * C + ax * s, c + az * az * C,
    )


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def quat_integrate(q, omega, dt):
    """q ← normalize(q ⊗ exp(ω·dt/2)) — matches ``spatial.quat_integrate``."""
    angle = torch.sqrt(v3_dot(omega, omega) + 0.0) * dt
    half = 0.5 * angle
    # A tensor divisor: PyTorch divides by a Python scalar on the card as a
    # product with its reciprocal, and the CPU and the kernels divide.
    sinc = torch.sinc(half / torch.full_like(half, math.pi))
    k = 0.5 * dt * sinc
    dq = (torch.cos(half), k * omega[0], k * omega[1], k * omega[2])
    out = quat_mul(q, dq)
    norm = torch.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2 + out[3] ** 2)
    return (out[0] / norm, out[1] / norm, out[2] / norm, out[3] / norm)


# -- spatial 6-vectors --------------------------------------------------


def sp(ang, lin):
    return ang + lin  # 6-tuple


def sp_ang(v):
    return v[0:3]


def sp_lin(v):
    return v[3:6]


def sp_add(a, b):
    return tuple(a[i] + b[i] for i in range(6))


def xup_motion(R, p, v):
    """Motion transform ``[R w; R(l − p×w)]`` of frame (R=child_R_parent,
    p=child origin in parent coords) applied to a parent-coords motion
    vector — equals ``motion_transform(R, p) @ v``."""
    w, l = sp_ang(v), sp_lin(v)
    return sp(m3_vec(R, w), m3_vec(R, v3_sub(l, v3_cross(p, w))))


def xup_force_T(R, p, f):
    """``motion_transform(R, p).T @ f`` — propagate a child-coords
    spatial force to parent coords (the RNEA/CRBA backward rule)."""
    n, l = sp_ang(f), sp_lin(f)
    Rt_n = m3T_vec(R, n)
    Rt_l = m3T_vec(R, l)
    return sp(v3_add(Rt_n, v3_cross(p, Rt_l)), Rt_l)


def crm_apply(v, m):
    """Spatial motion cross product ``crm(v) @ m``."""
    w, l = sp_ang(v), sp_lin(v)
    mw, ml = sp_ang(m), sp_lin(m)
    return sp(v3_cross(w, mw), v3_add(v3_cross(l, mw), v3_cross(w, ml)))


def crf_apply(v, f):
    """Spatial force cross product ``crf(v) @ f = -crm(v)ᵀ f``."""
    w, l = sp_ang(v), sp_lin(v)
    n, m = sp_ang(f), sp_lin(f)
    return sp(
        v3_add(v3_cross(w, n), v3_cross(l, m)),
        v3_cross(w, m),
    )


def inertia_apply(mass, com, Icom, v):
    """Spatial inertia (constant per body: python floats / 3-tuples /
    9-tuples of floats) applied to a motion vector:
    ``[Ī + m ĉĉᵀ, m ĉ; m ĉᵀ, m1] v`` with ĉ = skew(com)."""
    w, l = sp_ang(v), sp_lin(v)
    cx = com  # float 3-tuple
    # m ĉ l  and  m ĉᵀ w = -m ĉ w
    c_cross_l = v3_cross(cx, l)
    c_cross_w = v3_cross(cx, w)
    # Ī w (Icom is a row-major 9-tuple of floats)
    Iw = (
        Icom[0] * w[0] + Icom[1] * w[1] + Icom[2] * w[2],
        Icom[3] * w[0] + Icom[4] * w[1] + Icom[5] * w[2],
        Icom[6] * w[0] + Icom[7] * w[1] + Icom[8] * w[2],
    )
    # m ĉ (ĉᵀ w) = -m ĉ ĉ w  → the m ĉĉᵀ w term is -m ĉ(ĉ w)... careful:
    # (ĉ ĉᵀ) w = ĉ (ĉᵀ w) = skew(c) @ (skew(c).T @ w) = -ĉ(ĉ w)
    cc_w = v3_cross(cx, v3_cross(cx, w))  # = ĉ ĉ w
    ang = (
        Iw[0] - mass * cc_w[0] + mass * c_cross_l[0],
        Iw[1] - mass * cc_w[1] + mass * c_cross_l[1],
        Iw[2] - mass * cc_w[2] + mass * c_cross_l[2],
    )
    lin = (
        mass * (l[0] - c_cross_w[0]),
        mass * (l[1] - c_cross_w[1]),
        mass * (l[2] - c_cross_w[2]),
    )
    return sp(ang, lin)
