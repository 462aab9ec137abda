"""Spatial (6-D) vector algebra and quaternion helpers of the generic
rigid-body engine (Featherstone RBDA conventions).

Port of ``nnx_ppo_tpu/physics/spatial.py``. The JAX functions take one
vector or matrix and are vmapped; these take any leading (batch)
dimensions: vectors are ``[..., 3]`` / ``[..., 6]`` / ``[..., 4]``,
matrices ``[..., 3, 3]`` / ``[..., 6, 6]``. The lane (SoA) forms that the
kernels repeat live in ``soa.py``; ``quat_to_rot`` is shared with it.

Conventions:

* Spatial motion vectors are ``[ω(3); v(3)]`` (angular first), spatial
  forces ``[n(3); f(3)]`` (torque first), both expressed in the body's
  own coordinate frame at the body origin.
* ``(R, p)`` denotes a frame B placed at position ``p`` (in A coords)
  with rotation ``R = B_R_A`` mapping A-vectors to B-vectors.
* Quaternions are ``[w, x, y, z]`` scalar-first, normalized, and encode
  the body's orientation as an *active* rotation:
  ``world_vec = quat_to_rot(q) @ body_vec``.
"""

from __future__ import annotations

import math

import torch

from nnx_ppo_tpu_torch.physics.soa import quat_to_rot

__all__ = [
    "crf", "crm", "motion_transform", "quat_from_axis_angle", "quat_integrate", "quat_mul",
    "quat_to_rot", "skew", "spatial_inertia", "transform_force",
]


def _matrix(rows) -> torch.Tensor:
    """``[..., r, c]`` from nested lists of ``[...]`` tensors."""
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3×3 cross-product matrix: ``skew(v) @ u == cross(v, u)``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _matrix([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def _block(a, b, c, d) -> torch.Tensor:
    """``[[a, b], [c, d]]`` of equally shaped ``[..., k, k]`` blocks."""
    return torch.cat([torch.cat([a, b], dim=-1), torch.cat([c, d], dim=-1)], dim=-2)


def motion_transform(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Spatial motion transform ``B_X_A`` for frame B at ``(R, p)``:
    ``X = [[R, 0], [-R·skew(p), R]]`` (RBDA eq. 2.24-2.26)."""
    Z = torch.zeros_like(R)
    return _block(R, Z, -R @ skew(p), R)


def transform_force(X_motion: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Given the motion transform ``B_X_A``, forces map A←B via
    ``f_A = (B_X_A)ᵀ f_B`` (RBDA eq. 2.25)."""
    return (X_motion.transpose(-1, -2) @ f[..., None])[..., 0]


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor, inertia_com: torch.Tensor) -> torch.Tensor:
    """6×6 spatial inertia of a body about its frame origin from its mass
    (``[...]``), centre of mass (``[..., 3]``) and rotational inertia
    about the COM (``[..., 3, 3]``). RBDA eq. 2.63:
    ``I = [[Ī + m·cₓcₓᵀ, m·cₓ], [m·cₓᵀ, m·1]]``."""
    cx = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    return _block(inertia_com + m * cx @ cx.transpose(-1, -2), m * cx,
                  m * cx.transpose(-1, -2), m * eye)


def crm(v: torch.Tensor) -> torch.Tensor:
    """Spatial cross-product matrix (motion × motion), RBDA eq. 2.31."""
    sw, sv = skew(v[..., :3]), skew(v[..., 3:])
    return _block(sw, torch.zeros_like(sw), sv, sw)


def crf(v: torch.Tensor) -> torch.Tensor:
    """Spatial cross-product matrix (motion × force), RBDA eq. 2.32:
    ``crf(v) == -crm(v).T``."""
    return -crm(v).transpose(-1, -2)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_integrate(q: torch.Tensor, omega_body: torch.Tensor, dt) -> torch.Tensor:
    """Advance the orientation quaternion by body-frame angular velocity
    ``ω`` for ``dt`` via the exponential map (``q ← q ⊗ exp(ω·dt/2)``;
    exact for constant ω, renormalized against float drift)."""
    angle = torch.linalg.norm(omega_body, dim=-1) * dt
    half = 0.5 * angle
    # axis · sin(half), through sinc to avoid 0/0. A tensor divisor:
    # PyTorch divides by a Python scalar on the card as a product with its
    # reciprocal, where the CPU (and JAX) divide.
    axis_sin = 0.5 * dt * omega_body * torch.sinc(half / torch.full_like(half, math.pi))[..., None]
    dq = torch.cat([torch.cos(half)[..., None], axis_sin], dim=-1)
    out = quat_mul(q, dq)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1)
