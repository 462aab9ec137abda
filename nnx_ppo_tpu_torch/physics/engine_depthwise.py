"""Depth-wise batched dynamics: bodies at equal tree depth in one op.

Port of ``nnx_ppo_tpu/physics/engine_depthwise.py``. The generic engine
(``engine.py``) walks its body loops body by body: a quadruped's 12 leg
bodies are 12 sequential chains of small ops per pipeline stage, though
the four legs are independent. Here bodies are grouped by depth (the
distance from the root), and every per-body quantity of one level is
stacked on a ``K`` axis, so each stage runs ``depth`` batched ``[K, ...]``
operations instead of ``n_bodies`` sequential ones (the quadruped's 13
bodies are 4 levels after the root, each 4 wide). Like the generic
engine, every function takes any leading (batch) dimensions: per-level
tensors are ``[..., K, ...]``, and the order of operations is JAX's.

A parent sits exactly one level up, so the downward data flow is a
static gather (``parent_slot``) and the upward one a sum over each
parent's children. JAX's ``segment_sum`` would be a scatter-add, float
atomics on the card whose order changes from run to run; here each
upward sum is a fixed sequence of gathers and adds over a parent's
children in ascending order (:meth:`DepthPlan.constants`), the order of
JAX's sum, so two runs are equal to the bit.

Scope (:meth:`DepthPlan.build` raises JAX's ``ValueError`` otherwise, and
``LeggedJoystick(depthwise=None)`` falls back to the generic engine):
free-base models whose other joints are all hinges, the legged family.
Terrain, joint limits, springs, sphere-sphere pairs, domain
randomization (``mass_scale`` per env or per body) and external point
forces are supported. The plan's constants are copied to a device once,
at its first use there (:meth:`DepthPlan.constants`); the limit and
spring torques come from ``engine.py``, which builds its constants at
each call.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from nnx_ppo_tpu_torch.ops.linalg import (
    cholesky_backsub,
    cholesky_factor_blocked,
    cholesky_solve_small,
    spd_inverse_from_factor,
)
from nnx_ppo_tpu_torch.physics.engine import limit_torques, spring_torques
from nnx_ppo_tpu_torch.physics.model import HINGE, Model
from nnx_ppo_tpu_torch.physics.soa import quat_to_rot


class Level(NamedTuple):
    """One tree depth: all per-body constants stacked on axis 0 (numpy)."""

    bodies: np.ndarray  # [K] body indices (model order)
    parent_slot: np.ndarray  # [K] index into the previous level's arrays
    axis: np.ndarray  # [K, 3] hinge axes (child frame)
    jpos: np.ndarray  # [K, 3] joint anchors (parent frame)
    dof_idx: np.ndarray  # [K] this body's dof position in qvel
    qpos_idx: np.ndarray  # [K] this body's angle position in qpos
    inertia: np.ndarray  # [K, 6, 6] spatial inertias about body origins


class GeomGroup(NamedTuple):
    """Contact spheres owned by bodies of one level, batched."""

    level: int
    slot: np.ndarray  # [G] owning body's index within the level
    offset: np.ndarray  # [G, 3] sphere centers (body frame)
    radius: np.ndarray  # [G]
    orig: np.ndarray  # [G] original geom indices (for the normals order)


def _sum_gather(segment_ids: np.ndarray, n_segments: int) -> np.ndarray:
    """``[n_segments, C]`` row indices: segment ``s``'s rows in ascending
    order, padded with ``len(segment_ids)`` (a zero row appended to the
    data), ``C`` the largest segment (at least 1)."""
    rows = [np.flatnonzero(segment_ids == s) for s in range(n_segments)]
    width = max([1] + [len(r) for r in rows])
    out = np.full((n_segments, width), len(segment_ids), np.int64)
    for s, r in enumerate(rows):
        out[s, :len(r)] = r
    return out


def _segment_sum(data: torch.Tensor, gather: torch.Tensor) -> torch.Tensor:
    """``jax.ops.segment_sum`` over dim -2 of ``data`` ``[..., R, d]`` by a
    :func:`_sum_gather` table ``[S, C]``: each segment's rows added in
    ascending order by fixed gathers (no scatter, no atomics)."""
    padded = torch.cat([data, torch.zeros_like(data[..., :1, :])], dim=-2)
    acc = padded[..., gather[:, 0], :]
    for c in range(1, gather.shape[1]):
        acc = acc + padded[..., gather[:, c], :]
    return acc


@dataclasses.dataclass(frozen=True, eq=False)
class DepthPlan:
    """Static depth decomposition of a :class:`Model` (numpy), with its
    tensors cached per device (:meth:`constants`)."""

    levels: tuple  # tuple[Level, ...]; levels[0] is the free root
    geom_groups: tuple  # tuple[GeomGroup, ...]
    root_inertia: np.ndarray  # [6, 6]
    dof_perm: np.ndarray  # joint-dof gather: C[6 + i] = concat(levels)[dof_perm[i]]
    normal_perm: np.ndarray  # normals reorder: out[i] = computed[normal_perm[i]]
    ancestor_mask: np.ndarray  # [NB, nv] 1.0 iff dof moves body (CRBA Gram form)
    mass: np.ndarray  # [NB] body masses (world-frame inertia rebuild)
    com: np.ndarray  # [NB, 3] body-frame COM offsets
    inertia_com: np.ndarray  # [NB, 3, 3] rotational inertias about the COM
    body_level: np.ndarray  # [NB] level index per body
    body_slot: np.ndarray  # [NB] slot within its level per body
    model: Model = dataclasses.field(repr=False)
    _device_constants: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def build(model: Model) -> "DepthPlan":
        """Group bodies by depth. Raises ``ValueError`` for models
        outside the supported family (callers fall back to
        ``engine.forward_dynamics``)."""
        if not model.free_base:
            raise ValueError("depthwise engine requires a free-base model")
        if any(t != HINGE for t in model.joint_type[1:]):
            raise ValueError("depthwise engine supports hinge joints only")
        depth = [0] * model.n_bodies
        for i in range(1, model.n_bodies):
            depth[i] = depth[model.parent[i]] + 1
        n_levels = max(depth) + 1
        by_depth = [[i for i in range(model.n_bodies) if depth[i] == d] for d in range(n_levels)]
        vslices = model.dof_slices()
        qslices = model.qpos_slices()
        inertias = [
            np.asarray(_np_spatial_inertia(model.mass[i], model.com[i], model.inertia[i]),
                       np.float32)
            for i in range(model.n_bodies)
        ]
        slot_of: dict[int, int] = {0: 0}
        levels = [Level(
            bodies=np.array([0]),
            parent_slot=np.array([-1]),
            axis=np.zeros((1, 3), np.float32),
            jpos=np.zeros((1, 3), np.float32),
            dof_idx=np.array([0]),
            qpos_idx=np.array([0]),
            inertia=inertias[0][None],
        )]
        for d in range(1, n_levels):
            bodies = by_depth[d]
            for b in bodies:
                slot_of[b] = bodies.index(b)
            levels.append(Level(
                bodies=np.asarray(bodies),
                parent_slot=np.asarray([slot_of[model.parent[b]] for b in bodies]),
                axis=np.asarray([model.joint_axis[b] for b in bodies], np.float32),
                jpos=np.asarray([model.joint_pos[b] for b in bodies], np.float32),
                dof_idx=np.asarray([vslices[b][0] for b in bodies]),
                qpos_idx=np.asarray([qslices[b][0] for b in bodies]),
                inertia=np.stack([inertias[b] for b in bodies]),
            ))
        # Joint-dof assembly permutation: level-concat order -> dof order.
        concat_dofs = (np.concatenate([lvl.dof_idx for lvl in levels[1:]])
                       if n_levels > 1 else np.zeros(0, np.int64))
        dof_perm = np.argsort(concat_dofs)
        # Geoms grouped by owning level.
        groups, order = [], []
        for d in range(n_levels):
            sel = [g for g, b in enumerate(model.geom_body) if depth[b] == d]
            if not sel:
                continue
            groups.append(GeomGroup(
                level=d,
                slot=np.asarray([slot_of[model.geom_body[g]] for g in sel]),
                offset=np.asarray([model.geom_offset[g] for g in sel], np.float32),
                radius=np.asarray([model.geom_radius[g] for g in sel], np.float32),
                orig=np.asarray(sel),
            ))
            order.extend(sel)
        normal_perm = np.argsort(np.asarray(order)) if order else np.zeros(0, np.int64)
        # Ancestor mask for the Gram-form CRBA: dof d moves body b iff
        # d's joint is on b's root path (self included).
        anc = np.zeros((model.n_bodies, model.nv), np.float32)
        for b in range(model.n_bodies):
            j = b
            while j >= 0:
                s, n = vslices[j]
                anc[b, s:s + n] = 1.0
                j = model.parent[j]
        body_level = np.zeros(model.n_bodies, np.int64)
        body_slot = np.zeros(model.n_bodies, np.int64)
        for d, bodies in enumerate(by_depth):
            for s, b in enumerate(bodies):
                body_level[b] = d
                body_slot[b] = s
        return DepthPlan(
            levels=tuple(levels),
            geom_groups=tuple(groups),
            root_inertia=inertias[0],
            dof_perm=dof_perm,
            normal_perm=normal_perm,
            ancestor_mask=anc,
            mass=np.asarray(model.mass, np.float32),
            com=np.asarray(model.com, np.float32),
            inertia_com=np.asarray(model.inertia, np.float32),
            body_level=body_level,
            body_slot=body_slot,
            model=model,
        )

    @property
    def slot_map(self) -> dict:
        """body index -> (level index, slot) for external-force routing."""
        out = {}
        for li, lvl in enumerate(self.levels):
            for s, b in enumerate(lvl.bodies):
                out[int(b)] = (li, s)
        return out

    def constants(self, device: torch.device) -> dict:
        """The plan's tensors on ``device``, built at the first call there
        and kept (a copy per call would stall the stream)."""
        key = str(device)
        if key not in self._device_constants:
            self._device_constants[key] = {
                k: v.to(device) if torch.is_tensor(v) else [t.to(device) for t in v]
                for k, v in self._host_constants().items()
            }
        return self._device_constants[key]

    def _host_constants(self) -> dict:
        """Every tensor the functions below read, on the host."""
        model = self.model

        def f32(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32)

        def i64(x):
            return torch.tensor(np.asarray(x), dtype=torch.int64)

        skews = [f32(_np_skew(lvl.axis)) for lvl in self.levels]
        sizes = [len(lvl.bodies) for lvl in self.levels]
        out = {
            "eye3": torch.eye(3),
            "axis": [f32(lvl.axis) for lvl in self.levels],
            "jpos": [f32(lvl.jpos) for lvl in self.levels],
            "inertia": [f32(lvl.inertia) for lvl in self.levels],
            "bodies": [i64(lvl.bodies) for lvl in self.levels],
            "parent_slot": [i64(np.maximum(lvl.parent_slot, 0)) for lvl in self.levels],
            "dof_idx": [i64(lvl.dof_idx) for lvl in self.levels],
            "qpos_idx": [i64(lvl.qpos_idx) for lvl in self.levels],
            "axis_skew": skews,
            "axis_skew2": [k @ k for k in skews],
            # Children of each parent slot, for the upward sums.
            "up_gather": [i64(_sum_gather(np.zeros(1, np.int64), 1))] + [
                i64(_sum_gather(lvl.parent_slot, sizes[li - 1]))
                for li, lvl in enumerate(self.levels) if li > 0
            ],
            "geom_slot": [i64(g.slot) for g in self.geom_groups],
            "geom_offset": [f32(g.offset) for g in self.geom_groups],
            "geom_radius": [f32(g.radius) for g in self.geom_groups],
            "geom_gather": [i64(_sum_gather(g.slot, sizes[g.level])) for g in self.geom_groups],
            "dof_perm": i64(self.dof_perm),
            "normal_perm": i64(self.normal_perm),
            "ancestor_mask": f32(self.ancestor_mask),
            "mass": f32(self.mass),
            "com": f32(self.com),
            "inertia_com": f32(self.inertia_com),
            "body_gather": i64(_body_gather(self)),
            "armature": f32(model.armature),
            "damping": f32(model.damping),
            "gravity": f32([0.0, 0.0, -model.gravity]),
        }
        if model.pair_geom_a:
            offsets = np.cumsum([0] + sizes)
            smap = self.slot_map

            def side(geoms):
                at = [smap[int(model.geom_body[g])] for g in geoms]
                return (np.array([offsets[li] + s for li, s in at]),
                        np.array([li for li, _ in at]),
                        np.stack([model.geom_offset[g] for g in geoms]).astype(np.float32),
                        np.array([model.geom_radius[g] for g in geoms], np.float32))

            flat_a, lvl_a, off_a, rad_a = side(model.pair_geom_a)
            flat_b, lvl_b, off_b, rad_b = side(model.pair_geom_b)
            # Endpoint rows [b sides; a sides] of each level, by slot.
            ep_lvl = np.concatenate([lvl_b, lvl_a])
            ep_flat = np.concatenate([flat_b, flat_a])
            pair_levels = [li for li in range(len(self.levels)) if (ep_lvl == li).any()]
            out.update({
                "pair_a": i64(flat_a), "pair_b": i64(flat_b),
                "pair_off_a": f32(off_a), "pair_off_b": f32(off_b),
                "pair_rad_a": f32(rad_a), "pair_rad_b": f32(rad_b),
                "pair_levels": i64(pair_levels),
                "pair_gather": [
                    i64(_sum_gather(np.where(ep_lvl == li, ep_flat - offsets[li], -1),
                                    sizes[li]))
                    for li in pair_levels
                ],
            })
        return out


def _np_skew(v: np.ndarray) -> np.ndarray:
    """``[K, 3]`` vectors -> ``[K, 3, 3]`` cross-product matrices."""
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    zero = np.zeros_like(x)
    return np.stack([np.stack([zero, -z, y], -1), np.stack([z, zero, -x], -1),
                     np.stack([-y, x, zero], -1)], -2)


def _np_spatial_inertia(mass, com, inertia_com):
    cx = np.array([[0.0, -com[2], com[1]], [com[2], 0.0, -com[0]], [-com[1], com[0], 0.0]])
    return np.block([
        [inertia_com + mass * cx @ cx.T, mass * cx],
        [mass * cx.T, mass * np.eye(3)],
    ])


def _body_gather(plan: DepthPlan) -> np.ndarray:
    """Static gather indices: level-concat order -> body order [NB]."""
    sizes = [len(lvl.bodies) for lvl in plan.levels]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return offs[plan.body_level] + plan.body_slot


# ----------------------------------------------------------------------
# Batched ([..., K, ...]) spatial helpers, formula-identical to JAX's.
# ----------------------------------------------------------------------


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix @ vector over leading dims: ``[..., m, n] @ [..., n]``."""
    return (M @ v[..., None])[..., 0]


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrixᵀ @ vector over leading dims: ``[..., n, m]ᵀ @ [..., n]``."""
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _xup_motion(R_cp: torch.Tensor, r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``motion_transform(R_cp, r)`` applied to parent-frame spatial motion
    ``v``: ``(E w, E (l − r × w))``."""
    w, l = v[..., :3], v[..., 3:]
    return torch.cat([_mv(R_cp, w), _mv(R_cp, l - _cross(r, w))], dim=-1)


def _xup_force_up(R_cp: torch.Tensor, r: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``Xᵀ f``: child-frame spatial force -> parent frame:
    ``(Eᵀ n + r × (Eᵀ f), Eᵀ f)`` with ``E = R_cp``."""
    n, fl = f[..., :3], f[..., 3:]
    fl_p = _mtv(R_cp, fl)
    return torch.cat([_mtv(R_cp, n) + _cross(r, fl_p), fl_p], dim=-1)


def _crm_apply(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product ``v ×ₘ u``."""
    w, l = v[..., :3], v[..., 3:]
    uw, ul = u[..., :3], u[..., 3:]
    return torch.cat([_cross(w, uw), _cross(l, uw) + _cross(w, ul)], dim=-1)


def _crf_apply(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product ``v ×f g``: ``(w × n + l × f, w × f)``."""
    w, l = v[..., :3], v[..., 3:]
    n, f = g[..., :3], g[..., 3:]
    return torch.cat([_cross(w, n) + _cross(l, f), _cross(w, f)], dim=-1)


def _mass_scale(params, batch_ndim: int) -> tuple:
    """``(scale, per_body)``: the DR mass scale (per env ``[...]`` or per
    body ``[..., NB]``), or ``(None, False)``."""
    if params is None or params.mass_scale is None:
        return None, False
    s = params.mass_scale
    return s, s.ndim > batch_ndim


def _level_inertias(c: dict, params, batch_ndim: int) -> list:
    """Per-level ``[K, 6, 6]`` (or ``[..., K, 6, 6]``) spatial inertias,
    DR mass-scaled if given."""
    s, per_body = _mass_scale(params, batch_ndim)
    out = []
    for I, bodies in zip(c["inertia"], c["bodies"]):
        if s is not None:
            I = I * (s[..., bodies][..., None, None] if per_body else s[..., None, None, None])
        out.append(I)
    return out


def _damping(c: dict, params) -> torch.Tensor:
    """Per-dof viscous damping ``[nv]`` (``[..., nv]`` with a per-env
    ``damping_scale``; ``engine._scaled_damping`` on the cached tensor)."""
    damping = c["damping"]
    if params is not None and params.damping_scale is not None:
        damping = damping * params.damping_scale[..., None]
    return damping


# ----------------------------------------------------------------------
# Pipeline stages
# ----------------------------------------------------------------------


def fwd_kinematics_dw(model: Model, plan: DepthPlan, qpos: torch.Tensor) -> tuple:
    """Per-level kinematics: lists of ``E`` ``[..., K, 3, 3]``
    (world_R_body), ``p`` ``[..., K, 3]`` (world origins), ``R_cp``
    ``[..., K, 3, 3]`` (child_R_parent; ``None`` at the root)."""
    del model
    c = plan.constants(qpos.device)
    E, p, R_cp = [quat_to_rot(qpos[..., 3:7])[..., None, :, :]], [qpos[..., None, 0:3]], [None]
    for li in range(1, len(plan.levels)):
        q = qpos[..., c["qpos_idx"][li]]
        s, co = torch.sin(q)[..., None, None], torch.cos(q)[..., None, None]
        R_j = c["eye3"] + s * c["axis_skew"][li] + (1.0 - co) * c["axis_skew2"][li]
        ps = c["parent_slot"][li]
        E_par, p_par = E[-1][..., ps, :, :], p[-1][..., ps, :]
        E.append(E_par @ R_j)
        p.append(p_par + _mv(E_par, c["jpos"][li]))
        R_cp.append(R_j.transpose(-1, -2))
    return E, p, R_cp


def _velocities(plan: DepthPlan, c: dict, R_cp: list, qvel: torch.Tensor) -> list:
    """Per-level spatial velocities ``[..., K, 6]`` (own body frame)."""
    v = [qvel[..., None, 0:6]]
    for li in range(1, len(plan.levels)):
        vi = _xup_motion(R_cp[li], c["jpos"][li], v[-1][..., c["parent_slot"][li], :])
        ang = c["axis"][li] * qvel[..., c["dof_idx"][li]][..., None]
        v.append(torch.cat([vi[..., :3] + ang, vi[..., 3:]], dim=-1))
    return v


def mass_matrix_dw(
    model: Model, plan: DepthPlan, qpos: torch.Tensor, params=None, kin=None
) -> torch.Tensor:
    """CRBA joint-space inertia in Gram form, ``M = Σ_b Φ_bᵀ I_b Φ_b``
    (JAX ``engine_depthwise.py:390``): every dof's motion axis in one
    common frame (world axes at the base body's origin, which keeps lever
    arms short wherever the robot has walked), each body's spatial
    inertia rebuilt in that frame, and a static ``[NB, nv]`` ancestor
    mask selecting the dofs that move each body; M assembles as two
    batched products over all bodies at once. ``kin``: the
    :func:`fwd_kinematics_dw` result to reuse. Includes the armature
    diagonal, like the generic CRBA. ``[..., nv, nv]``."""
    if kin is None:
        kin = fwd_kinematics_dw(model, plan, qpos)
    E, p, _ = kin
    c = plan.constants(qpos.device)
    gather = c["body_gather"]
    E_all = torch.cat(E, dim=-3)[..., gather, :, :]  # [..., NB, 3, 3]
    p_all = torch.cat(p, dim=-2)[..., gather, :]  # [..., NB, 3]
    p0 = p_all[..., 0:1, :]

    # World-axes spatial inertia of every body about the base origin.
    m = c["mass"]
    c_rel = p_all + _mv(E_all, c["com"]) - p0  # COM − base
    Ic_w = E_all @ c["inertia_com"] @ E_all.transpose(-1, -2)
    x, y, z = c_rel[..., 0], c_rel[..., 1], c_rel[..., 2]
    zero = torch.zeros_like(x)
    cx = torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                      torch.stack([-y, x, zero], -1)], -2)  # skew(c_rel)
    mm = m[:, None, None]
    cxT = cx.transpose(-1, -2)
    I_O = torch.cat([
        torch.cat([Ic_w + mm * cx @ cxT, mm * cx], -1),
        torch.cat([mm * cxT, (mm * c["eye3"]).expand_as(cx)], -1),
    ], -2)  # [..., NB, 6, 6]
    s, per_body = _mass_scale(params, qpos.ndim - 1)
    if s is not None:
        I_O = I_O * (s[..., None, None] if per_body else s[..., None, None, None])

    # Per-dof motion axes in the common frame ([..., nv, 6] rows).
    E0T = E[0][..., 0, :, :].transpose(-1, -2)
    zeros3 = torch.zeros_like(E0T)
    root_rows = torch.cat([torch.cat([E0T, zeros3], -1), torch.cat([zeros3, E0T], -1)], -2)
    joint_rows = []
    for li in range(1, len(plan.levels)):
        axis_w = _mv(E[li], c["axis"][li])  # [..., K, 3]
        joint_rows.append(torch.cat([axis_w, _cross(p[li] - p0, axis_w)], -1))
    phi = root_rows
    if joint_rows:
        phi = torch.cat([root_rows, torch.cat(joint_rows, -2)[..., c["dof_perm"], :]], -2)

    phi_m = phi[..., None, :, :] * c["ancestor_mask"][:, :, None]  # [..., NB, nv, 6]
    T = phi_m @ I_O
    M = torch.einsum("...bvj,...bwj->...vw", T, phi_m)
    return M + torch.diag(c["armature"])


def _damped(M: torch.Tensor, c: dict, dt: float, params) -> torch.Tensor:
    return M + dt * torch.diag_embed(_damping(c, params)) if dt else M


def mass_matrix_factor_dw(
    model: Model, plan: DepthPlan, qpos: torch.Tensor, *, dt: float, params=None
) -> torch.Tensor:
    """Lower Cholesky factor of ``M + dt·D`` via the Gram-form CRBA, for
    ``engine.mass_matrix_factor``'s callers on plan-supported models (the
    implicit joint damping is baked in, so ``dt`` must match the
    integration step)."""
    c = plan.constants(qpos.device)
    return cholesky_factor_blocked(_damped(mass_matrix_dw(model, plan, qpos, params), c, dt,
                                           params))


def mass_matrix_inverse_dw(
    model: Model, plan: DepthPlan, qpos: torch.Tensor, *, dt: float, params=None
) -> torch.Tensor:
    """Explicit ``(M + dt·D)⁻¹`` via the Gram-form CRBA (JAX ``:494``):
    held over a control step's substeps, each substep's solve is one
    matvec instead of two triangular substitutions; built once per
    control step from the Cholesky factor by the recursive triangular
    inverse (``ops/linalg.py``). The same approximation as
    ``reuse_mass_matrix``."""
    c = plan.constants(qpos.device)
    L = cholesky_factor_blocked(_damped(mass_matrix_dw(model, plan, qpos, params), c, dt,
                                        params))
    return spd_inverse_from_factor(L)


def forward_dynamics_dw(
    model: Model,
    plan: DepthPlan,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    tau_applied: torch.Tensor,
    dt: float = 0.0,
    chol: Optional[torch.Tensor] = None,
    external_forces: Optional[list] = None,
    terrain=None,
    params=None,
    minv: Optional[torch.Tensor] = None,
) -> tuple:
    """Depth-batched ``engine.forward_dynamics``, the same contract
    (JAX ``engine_depthwise.py:520``): returns ``(qacc [..., nv], contact
    normal forces [..., NG + NP]`` in the original geom order, ground
    geoms first, then the pairs). ``minv``: a held explicit inverse from
    :func:`mass_matrix_inverse_dw` (the solve becomes one matvec; it
    takes precedence over ``chol``)."""
    c = plan.constants(qpos.device)
    E, p, R_cp = fwd_kinematics_dw(model, plan, qpos)
    v = _velocities(plan, c, R_cp, qvel)
    I = _level_inertias(c, params, qpos.ndim - 1)
    n_levels = len(plan.levels)

    # RNEA forward: accelerations with q̈ = 0, gravity as world accel.
    a0_lin = _mtv(E[0][..., 0, :, :], c["gravity"])
    a = [torch.cat([torch.zeros_like(a0_lin), a0_lin], -1)[..., None, :]]
    for li in range(1, n_levels):
        ai = _xup_motion(R_cp[li], c["jpos"][li], a[-1][..., c["parent_slot"][li], :])
        ang = c["axis"][li] * qvel[..., c["dof_idx"][li]][..., None]
        a.append(ai + _crm_apply(v[li], torch.cat([ang, torch.zeros_like(ang)], -1)))
    f = [_mv(I[li], a[li]) + _crf_apply(v[li], _mv(I[li], v[li])) for li in range(n_levels)]

    # Contacts: fold spatial forces into f (subtract: external forces
    # enter the rhs positively and f feeds the bias side).
    normals = []
    friction = model.friction
    if params is not None and params.friction is not None:
        friction = params.friction[..., None]
    for gi, grp in enumerate(plan.geom_groups):
        li = grp.level
        slot = c["geom_slot"][gi]
        E_g, p_g, v_g = E[li][..., slot, :, :], p[li][..., slot, :], v[li][..., slot, :]
        offset, radius = c["geom_offset"][gi], c["geom_radius"][gi]
        centers = p_g + _mv(E_g, offset)  # [..., G, 3] world centers
        w_g, l_g = v_g[..., :3], v_g[..., 3:]
        if terrain is None:
            phi = radius - centers[..., 2]
            # Contact point: one radius below the center in world z.
            contact_offset = offset + -radius[:, None] * E_g[..., 2, :]
            v_pt = _mv(E_g, l_g + _cross(w_g, contact_offset))
            fn = torch.where(
                phi > 0.0,
                torch.clamp(model.contact_stiffness * phi - model.contact_damping * v_pt[..., 2],
                            min=0.0),
                0.0,
            )
            if np.isfinite(model.max_contact_force):
                fn = torch.clamp(fn, max=model.max_contact_force)
            vt = v_pt[..., :2]
            vt_norm = torch.sqrt(torch.sum(vt**2, -1) + 1e-6)
            scale = -friction * fn / torch.clamp(vt_norm, min=model.friction_vel)
            f_w = torch.cat([scale[..., None] * vt, fn[..., None]], -1)
        else:
            xy = centers[..., :2]
            n = terrain.normal(xy)
            h = terrain.height(xy)
            phi = radius - (centers[..., 2] - h) * n[..., 2]
            contact_offset = offset + _mtv(E_g, -n * radius[:, None])
            v_pt = _mv(E_g, l_g + _cross(w_g, contact_offset))
            vn = torch.sum(n * v_pt, -1)
            fn = torch.where(
                phi > 0.0,
                torch.clamp(model.contact_stiffness * phi - model.contact_damping * vn, min=0.0),
                0.0,
            )
            if np.isfinite(model.max_contact_force):
                fn = torch.clamp(fn, max=model.max_contact_force)
            vt = v_pt - vn[..., None] * n
            vt_norm = torch.sqrt(torch.sum(vt**2, -1) + 1e-6)
            ft = (-friction * fn / torch.clamp(vt_norm, min=model.friction_vel))[..., None] * vt
            f_w = fn[..., None] * n + ft
        normals.append(fn)
        f_b = _mtv(E_g, f_w)
        f_sp = torch.cat([_cross(contact_offset, f_b), f_b], -1)  # [..., G, 6]
        f[li] = f[li] - _segment_sum(f_sp, c["geom_gather"][gi])

    # Sphere-sphere collision pairs (a static list), batched over all P
    # pairs at once: equal and opposite at one world point.
    pair_normals = None
    if model.pair_geom_a:
        E_all, p_all, v_all = torch.cat(E, -3), torch.cat(p, -2), torch.cat(v, -2)
        ia, ib = c["pair_a"], c["pair_b"]
        E_a, p_a, v_a = E_all[..., ia, :, :], p_all[..., ia, :], v_all[..., ia, :]
        E_b, p_b, v_b = E_all[..., ib, :, :], p_all[..., ib, :], v_all[..., ib, :]
        rad_a, rad_b = c["pair_rad_a"], c["pair_rad_b"]
        xa = p_a + _mv(E_a, c["pair_off_a"])  # [..., P, 3] world centers
        xb = p_b + _mv(E_b, c["pair_off_b"])
        d = xb - xa
        dist = torch.sqrt(torch.sum(d**2, -1) + 1e-12)
        n = d / dist[..., None]  # contact normal, a -> b
        phi = (rad_a + rad_b) - dist
        c_w = xa + n * (rad_a - 0.5 * phi)[..., None]

        def point_vel(E_g, p_g, v_g):
            r_loc = _mtv(E_g, c_w - p_g)
            return _mv(E_g, v_g[..., 3:] + _cross(v_g[..., :3], r_loc))

        v_rel = point_vel(E_b, p_b, v_b) - point_vel(E_a, p_a, v_a)
        sep = torch.sum(n * v_rel, -1)  # separation rate (= -φ̇)
        fn = torch.where(
            phi > 0.0,
            torch.clamp(model.contact_stiffness * phi - model.contact_damping * sep, min=0.0),
            0.0,
        )
        if np.isfinite(model.max_contact_force):
            fn = torch.clamp(fn, max=model.max_contact_force)
        vt = v_rel - sep[..., None] * n
        vt_norm = torch.sqrt(torch.sum(vt**2, -1) + 1e-6)
        ft = (-friction * fn / torch.clamp(vt_norm, min=model.friction_vel))[..., None] * vt
        f_w = fn[..., None] * n + ft  # [..., P, 3] on body b; a gets -f_w
        pair_normals = fn
        sides = []
        for E_g, p_g, sign in ((E_b, p_b, 1.0), (E_a, p_a, -1.0)):
            r_loc = _mtv(E_g, c_w - p_g)
            f_bd = _mtv(E_g, sign * f_w)
            sides.append(torch.cat([_cross(r_loc, f_bd), f_bd], -1))
        f_sp_all = torch.cat(sides, -2)  # [..., 2P, 6]
        for li, gather in zip(c["pair_levels"].tolist(), c["pair_gather"]):
            f[li] = f[li] - _segment_sum(f_sp_all, gather)

    # External world-frame point forces [(body, point_world, f_world)].
    if external_forces:
        smap = plan.slot_map
        for b, point_w, f_w in external_forces:
            li, s = smap[int(b)]
            E_b, p_b = E[li][..., s, :, :], p[li][..., s, :]
            f_b = _mtv(E_b, f_w)
            f_sp = torch.cat([_cross(_mtv(E_b, point_w - p_b), f_b), f_b], -1)
            f[li] = torch.cat([f[li][..., :s, :], (f[li][..., s, :] - f_sp)[..., None, :],
                               f[li][..., s + 1:, :]], -2)

    # Backward pass: project on joint subspaces, propagate to parents.
    joint_vals = [None] * (n_levels - 1)
    for li in range(n_levels - 1, 0, -1):
        joint_vals[li - 1] = torch.sum(c["axis"][li] * f[li][..., :3], -1)  # [..., K] Sᵀ f
        up = _xup_force_up(R_cp[li], c["jpos"][li], f[li])
        f[li - 1] = f[li - 1] + _segment_sum(up, c["up_gather"][li])

    C = f[0][..., 0, :]
    if joint_vals:
        C = torch.cat([C, torch.cat(joint_vals, -1)[..., c["dof_perm"]]], -1)
    C = C + _damping(c, params) * qvel

    rhs = tau_applied - C
    tau_l = limit_torques(model, qpos, qvel)
    if tau_l is not None:
        rhs = rhs + tau_l
    tau_s = spring_torques(model, qpos)
    if tau_s is not None:
        rhs = rhs + tau_s

    if plan.geom_groups:
        all_normals = torch.cat(normals, -1)[..., c["normal_perm"]]
    else:
        all_normals = torch.zeros(qpos.shape[:-1] + (0,), device=qpos.device)
    if pair_normals is not None:
        # The generic engine's layout: the NG ground normals first, then
        # the pairs in declaration order.
        all_normals = torch.cat([all_normals, pair_normals], -1)

    if minv is not None:
        return _mv(minv, rhs), all_normals
    if chol is not None:
        return cholesky_backsub(chol, rhs), all_normals
    M = _damped(mass_matrix_dw(model, plan, qpos, params, kin=(E, p, R_cp)), c, dt, params)
    return cholesky_solve_small(M, rhs), all_normals
