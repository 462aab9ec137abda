"""Static rigid-body model description of the reference physics (numpy
only; a frozen copy of ``nnx_ppo_tpu_torch/physics/model.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

FREE = "free"
HINGE = "hinge"
SLIDE = "slide"
BALL = "ball"

# (qpos width, qvel width) per joint type.
JOINT_NQ = {FREE: 7, HINGE: 1, SLIDE: 1, BALL: 4}
JOINT_NV = {FREE: 6, HINGE: 1, SLIDE: 1, BALL: 3}


@dataclasses.dataclass(frozen=True)
class Model:
    """Static kinematic-tree description. All arrays are numpy constants."""

    parent: tuple[int, ...]  # parent body index; -1 = world
    joint_type: tuple[str, ...]  # FREE (body 0 only) / HINGE / SLIDE / BALL
    joint_axis: np.ndarray  # [NB, 3] hinge/slide axis in child frame
    joint_pos: np.ndarray  # [NB, 3] child-frame origin in parent coords (q=0)
    mass: np.ndarray  # [NB]
    com: np.ndarray  # [NB, 3] center of mass in body frame
    inertia: np.ndarray  # [NB, 3, 3] rotational inertia about the COM
    geom_body: tuple[int, ...]  # contact sphere: owning body
    geom_offset: np.ndarray  # [NG, 3] sphere center in body frame
    geom_radius: np.ndarray  # [NG]
    damping: np.ndarray  # [nv] per-dof viscous joint damping
    armature: np.ndarray  # [nv] added diagonal (rotor) inertia
    # Per-dof joint range (±inf = unlimited; only 1-dof joints can be
    # limited). Violations feel a spring-damper penalty torque — see
    # engine_soa.py::substep_soa.
    joint_lower: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )  # [nv]
    joint_upper: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )  # [nv]
    # Stiff enough that a strong PD controller pushing into the stop
    # only overshoots by a few hundredths of a radian; still stable
    # under semi-implicit Euler at 500 Hz for the in-repo models
    # (dt·√(k/I) < 1 for every limited dof).
    limit_stiffness: float = 3_000.0
    limit_damping: float = 30.0
    # Per-dof passive joint springs: τ = −k·(q − ref) on 1-dof joints
    # (k = 0 → no spring, zero cost; MuJoCo jnt_stiffness/springref).
    spring_stiffness: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )  # [nv]
    spring_ref: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )  # [nv]
    # Sphere-sphere collision pairs (geom indices; explicit static list
    # — self-collision within the tree, see engine_soa.py).
    pair_geom_a: tuple[int, ...] = ()
    pair_geom_b: tuple[int, ...] = ()
    gravity: float = -9.81

    # Contact model parameters (penalty/compliant; see engine_soa.py).
    contact_stiffness: float = 5_000.0
    contact_damping: float = 100.0
    friction: float = 0.8
    # Regularization velocity of the smooth-Coulomb friction (the knee
    # below which friction is viscous). The effective viscous slope is
    # ``friction·fn/friction_vel`` — explicit integration requires
    # ``slope·dt/m_eff < 2``, so light bodies / stiff impacts need a
    # larger knee and/or a normal-force cap to stay stable.
    friction_vel: float = 0.1
    # Upper bound on any single penalty normal force (∞ = uncapped).
    # Bounds both the impact force AND the friction slope during
    # violent collisions — without it a light free body whacked into
    # the ground can excite the explicit friction term into geometric
    # divergence (see docs/physics.md).
    max_contact_force: float = float("inf")

    @property
    def n_bodies(self) -> int:
        return len(self.parent)

    @property
    def nj(self) -> int:
        """Number of HINGE joints (the SoA/Pallas path is hinge-only and
        keys off this; for free-base + all-hinge models it equals the
        number of actuated dofs)."""
        return sum(1 for t in self.joint_type if t == HINGE)

    @property
    def nv(self) -> int:
        return sum(JOINT_NV[t] for t in self.joint_type)

    @property
    def nq(self) -> int:
        return sum(JOINT_NQ[t] for t in self.joint_type)

    @property
    def free_base(self) -> bool:
        return self.joint_type[0] == FREE

    def dof_slices(self) -> list[tuple[int, int]]:
        """Per-body (start, n_dofs) into qvel, in body order."""
        out = []
        cursor = 0
        for t in self.joint_type:
            n = JOINT_NV[t]
            out.append((cursor, n))
            cursor += n
        return out

    def qpos_slices(self) -> list[tuple[int, int]]:
        """Per-body (start, width) into qpos, in body order."""
        out = []
        cursor = 0
        for t in self.joint_type:
            n = JOINT_NQ[t]
            out.append((cursor, n))
            cursor += n
        return out


class ModelBuilder:
    """Incremental model construction (bodies in topological order)."""

    def __init__(self, gravity: float = -9.81):
        self._gravity = gravity
        self._parent: list[int] = []
        self._joint_type: list[str] = []
        self._joint_axis: list[np.ndarray] = []
        self._joint_pos: list[np.ndarray] = []
        self._mass: list[float] = []
        self._com: list[np.ndarray] = []
        self._inertia: list[np.ndarray] = []
        self._geom_body: list[int] = []
        self._geom_offset: list[np.ndarray] = []
        self._geom_radius: list[float] = []
        self._damping: list[float] = []
        self._armature: list[float] = []
        self._pair_a: list[int] = []
        self._pair_b: list[int] = []
        self._lower: list[float] = []
        self._upper: list[float] = []
        self._names: dict[str, int] = {}

    def add_body(
        self,
        name: str,
        *,
        parent: Optional[str] = None,
        joint: str = HINGE,
        axis=(0.0, 1.0, 0.0),
        pos=(0.0, 0.0, 0.0),
        mass: float = 1.0,
        com=(0.0, 0.0, 0.0),
        inertia=(0.01, 0.01, 0.01),
        damping: float = 0.0,
        armature: float = 0.0,
        limit: Optional[tuple[float, float]] = None,
    ) -> int:
        """Add a body jointed to ``parent`` (None = world; first body only).

        ``joint`` is one of ``hinge``/``slide``/``ball``/``free`` (free
        only on the base body). ``inertia`` is a diagonal ``[3]`` or full
        ``[3, 3]`` rotational inertia about the COM; ``pos`` is the child
        frame origin in parent coords at the zero configuration; ``axis``
        and ``limit`` (a ``(lower, upper)`` range in rad/m) apply to
        hinge/slide joints only.
        """
        if joint not in JOINT_NV:
            raise ValueError(f"unknown joint type {joint!r}")
        if parent is None:
            if self._parent:
                raise ValueError("only the first body may attach to the world")
            parent_idx = -1
        else:
            parent_idx = self._names[parent]
        if joint == FREE and self._parent:
            raise ValueError("free joint is only supported on the base body")
        idx = len(self._parent)
        self._names[name] = idx
        self._parent.append(parent_idx)
        self._joint_type.append(joint)
        self._joint_axis.append(np.asarray(axis, np.float64))
        self._joint_pos.append(np.asarray(pos, np.float64))
        self._mass.append(float(mass))
        self._com.append(np.asarray(com, np.float64))
        inertia = np.asarray(inertia, np.float64)
        self._inertia.append(np.diag(inertia) if inertia.ndim == 1 else inertia)
        n_dofs = JOINT_NV[joint]
        self._damping.extend([damping] * n_dofs)
        self._armature.extend([armature] * n_dofs)
        if limit is not None:
            if joint not in (HINGE, SLIDE):
                raise ValueError("limit applies to hinge/slide joints only")
            if not limit[0] < limit[1]:
                raise ValueError(f"empty joint range {limit}")
            self._lower.extend([float(limit[0])])
            self._upper.extend([float(limit[1])])
        else:
            self._lower.extend([-np.inf] * n_dofs)
            self._upper.extend([np.inf] * n_dofs)
        return idx

    def add_sphere_geom(self, body: str, offset, radius: float) -> int:
        """Add a contact sphere to ``body``; returns the geom index (for
        :meth:`add_collision_pair`). All geoms collide with the ground
        plane; sphere-sphere contact is opt-in per pair."""
        self._geom_body.append(self._names[body])
        self._geom_offset.append(np.asarray(offset, np.float64))
        self._geom_radius.append(float(radius))
        return len(self._geom_body) - 1

    def add_collision_pair(self, geom_a: int, geom_b: int) -> None:
        """Enable sphere-sphere penalty contact between two geoms (by
        index from :meth:`add_sphere_geom`). Pairs are an explicit static
        list — no broad-phase — so the trace stays fixed-shape and only
        plausible self-collisions pay any cost."""
        ng = len(self._geom_body)
        if not (0 <= geom_a < ng and 0 <= geom_b < ng):
            raise ValueError(f"geom index out of range: ({geom_a}, {geom_b})")
        if geom_a == geom_b:
            raise ValueError("a geom cannot collide with itself")
        if self._geom_body[geom_a] == self._geom_body[geom_b]:
            raise ValueError("collision pair within the same body")
        self._pair_a.append(geom_a)
        self._pair_b.append(geom_b)

    def body_index(self, name: str) -> int:
        return self._names[name]

    def finalize(self, **contact_params) -> Model:
        return Model(
            parent=tuple(self._parent),
            joint_type=tuple(self._joint_type),
            joint_axis=np.stack(self._joint_axis),
            joint_pos=np.stack(self._joint_pos),
            mass=np.asarray(self._mass),
            com=np.stack(self._com),
            inertia=np.stack(self._inertia),
            geom_body=tuple(self._geom_body),
            geom_offset=(
                np.stack(self._geom_offset)
                if self._geom_offset
                else np.zeros((0, 3))
            ),
            geom_radius=np.asarray(self._geom_radius),
            pair_geom_a=tuple(self._pair_a),
            pair_geom_b=tuple(self._pair_b),
            damping=np.asarray(self._damping),
            armature=np.asarray(self._armature),
            joint_lower=np.asarray(self._lower),
            joint_upper=np.asarray(self._upper),
            gravity=self._gravity,
            **contact_params,
        )
