"""MJCF import: load MuJoCo robot models into the port's rigid-body engine.

Port of ``nnx_ppo_tpu/physics/mjcf.py``: ``ActuatorSpec`` (:128),
``MjcfImport`` (:159), ``MjcfSceneImport`` (:223), ``from_mjcf`` (:233),
``from_mjcf_scene`` (:278), ``_translate`` (:318) and the quaternion
helpers (:80-127). The JAX module imports only numpy and ``model.py``, so
this is the port's own copy of it with the port's ``Model``,
``HeightGrid`` (a world hfield, JAX :534-560) and ``Scene``; nothing of
the JAX package is imported. It translates a compiled
:class:`mujoco.MjModel` (the installed ``mujoco`` package does all
parsing and compilation: units, defaults, includes) into a
:class:`~nnx_ppo_tpu_torch.physics.model.Model`. ``mujoco`` is imported
inside the functions that need it, so the package imports on a machine
without it; ``physics/models/mjcf_quadruped.py`` rebuilds a saved import
with numpy alone.

Supported subset:

* free (base), hinge, slide, and ball joints; per-dof damping,
  armature, passive joint springs (``jnt_stiffness``/``springref``),
  and hinge/slide ranges (imported as the engine's penalty stops —
  MuJoCo treats ranges as solver constraints, so limit *dynamics*
  differ while the admissible range matches);
* bodies with MULTIPLE stacked joints (planar roots like
  slide-slide-hinge) decompose into chained massless links — MuJoCo
  composes stacked joints in declaration order, first joint outermost;
* welded bodies (zero joints) merge into their nearest jointed
  ancestor exactly: masses, COMs, and inertias combine via the
  parallel-axis theorem; geoms and children re-attach through the weld;
* fixed child-frame rotations (``body_quat``) and joint anchors
  (``jnt_pos``): the engine's child frame is *parent-aligned at the
  joint anchor*, so both are unrolled into the imported constants
  (exact; ball-joint states and axes are conjugated by the same
  rotation);
* sphere geoms become contact spheres **iff** the MJCF declares a
  z = 0 world ground plane (the engine's implicit ground; importing
  contact spheres from a floorless MJCF would invent collisions) or
  ``force_contacts=True``; explicit ``<pair>`` elements between two
  imported spheres become engine collision pairs. Other geom types
  only contribute their (already-compiled) body inertia.

NOT translated: MuJoCo's constraint-based contact model (solref /
solimp) — the engine uses penalty/compliant contacts, so pass
``contact_stiffness``/``contact_damping``/``friction`` explicitly;
the fluid model (density/viscosity/wind — import fails loudly);
tendons and sensors; actuators beyond the metadata in
:class:`ActuatorSpec` (the envs own actuation); non-sphere collision
geometry beyond the capsule two-sphere approximation.

Exactness: the *smooth* dynamics (mass matrix, bias forces, gravity,
damping, armature) of imported models match MuJoCo's own
``mj_forward``/``mj_fullM`` to float tolerance
(``tests/test_torch_mjcf.py``), including the free-joint
velocity-convention conversion (MuJoCo: world-frame linear then
body-frame angular; engine: body-frame, angular first).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from nnx_ppo_tpu_torch.physics.model import BALL, FREE, HINGE, SLIDE, Model

# mjtJoint / mjtGeom codes kept literal so this module only imports
# mujoco inside from_mjcf (the package imports fine without mujoco).
_MJ_FREE, _MJ_BALL, _MJ_SLIDE, _MJ_HINGE = 0, 1, 2, 3
_JOINT_TYPE = {
    _MJ_FREE: FREE,
    _MJ_BALL: BALL,
    _MJ_SLIDE: SLIDE,
    _MJ_HINGE: HINGE,
}
_NV = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}
_NQ = {FREE: 7, BALL: 4, SLIDE: 1, HINGE: 1}
_MJ_GEOM_PLANE, _MJ_GEOM_HFIELD, _MJ_GEOM_SPHERE = 0, 1, 2
_WORLD = -1


def _quat_to_mat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion [w, x, y, z] (Shepperd)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [
                0.25 * s,
                (R[2, 1] - R[1, 2]) / s,
                (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s,
            ]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


class ActuatorSpec:
    """One MJCF joint actuator, translated to engine terms.

    The engine applies raw generalized torques (the env owns control),
    so actuators import as METADATA for envs to consume: ``dof`` is the
    engine qvel index the actuator drives, ``kind`` one of ``"motor"``
    (``τ = gear · ctrl``), ``"position"`` (PD: ``τ = kp·(ctrl − q) −
    kv·q̇``), ``"velocity"`` (``τ = kv·(ctrl − q̇)``), or ``"other"``
    (unrecognized gain/bias structure — use the raw fields)."""

    __slots__ = ("name", "joint", "dof", "kind", "gear", "kp", "kv",
                 "ctrlrange")

    def __init__(self, name, joint, dof, kind, gear, kp, kv, ctrlrange):
        self.name = name
        self.joint = joint
        self.dof = dof
        self.kind = kind
        self.gear = gear
        self.kp = kp
        self.kv = kv
        self.ctrlrange = ctrlrange

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"ActuatorSpec({self.name!r}, joint={self.joint!r}, "
            f"dof={self.dof}, kind={self.kind!r})"
        )


@dataclasses.dataclass(frozen=True)
class MjcfImport:
    """Result of :func:`from_mjcf`."""

    model: Model
    qpos0: np.ndarray  # engine-layout reference configuration
    body_names: tuple  # our body index → MJCF body name
    geom_names: tuple  # our contact-geom index → MJCF geom name
    skipped_geoms: tuple  # MJCF geom names not imported as contacts
    has_ground: bool  # MJCF declared a world ground (plane or hfield)
    actuators: tuple = ()  # joint ActuatorSpecs (env-consumed metadata)
    # World hfield geom translated to a bilinear HeightGrid terrain;
    # None = flat z = 0 ground. IMPORTANT: when set, the caller must
    # pass it to the engine/env (`terrain=imp.terrain` —
    # `legged_from_mjcf` does this automatically): the engine's default
    # ground is the flat z = 0 plane, so running the model without the
    # terrain would collide contacts against ground the MJCF never
    # declared.
    terrain: Optional[object] = None
    # Ball joints whose body carried a fixed rotation (body_quat /
    # inherited frame / hinge-ref fold): (engine dof index, W_R) pairs;
    # their mj angular dofs live in the mj body frame while the engine's
    # live in the unrolled frame — conjugate by W_R on conversion.
    ball_dof_rotations: tuple = ()

    def qvel_from_mujoco(self, qpos, qvel_mj) -> np.ndarray:
        """MuJoCo qvel → engine qvel.

        Free joints: MuJoCo stores ``[v_world(3), ω_body(3)]``, the
        engine ``[ω_body(3), v_body(3)]``; ``qpos`` (identical layout
        in both) supplies the base orientation. Ball-joint angular
        dofs rotate by the body's unrolled frame (``W_R ω_mj``); other
        dofs coincide."""
        out = np.asarray(qvel_mj, np.float64).copy()
        if self.model.free_base:
            E = _quat_to_mat(np.asarray(qpos[3:7], np.float64))
            out[0:3] = np.asarray(qvel_mj[3:6])
            out[3:6] = E.T @ np.asarray(qvel_mj[0:3])
        for dof, R in self.ball_dof_rotations:
            out[dof : dof + 3] = R @ out[dof : dof + 3]
        return out

    def qacc_from_mujoco(self, qpos, qvel_mj, qacc_mj) -> np.ndarray:
        """MuJoCo qacc → engine qacc (free-base transport term; ball
        dofs conjugated like :meth:`qvel_from_mujoco`).

        The engine's linear acceleration dof is ``d/dt(v_body)``;
        MuJoCo's is ``d/dt(v_world)``. With ``v_body = Eᵀ v_world``:
        ``v̇_body = Eᵀ v̇_world − ω_body × v_body``."""
        out = np.asarray(qacc_mj, np.float64).copy()
        if self.model.free_base:
            E = _quat_to_mat(np.asarray(qpos[3:7], np.float64))
            w_body = np.asarray(qvel_mj[3:6])
            v_body = E.T @ np.asarray(qvel_mj[0:3])
            out[0:3] = qacc_mj[3:6]
            out[3:6] = E.T @ np.asarray(qacc_mj[0:3]) - np.cross(
                w_body, v_body
            )
        for dof, R in self.ball_dof_rotations:
            out[dof : dof + 3] = R @ out[dof : dof + 3]
        return out



@dataclasses.dataclass(frozen=True)
class MjcfSceneImport:
    """Result of :func:`from_mjcf_scene`: one engine tree per
    root-attached jointed subtree, plus the cross-tree contact pairs
    declared by ``<pair>`` elements."""

    scene: "object"  # physics.scene.Scene
    qpos0s: tuple  # per-tree engine-layout reference configurations
    imports: tuple  # per-tree MjcfImport (names, converters)


def from_mjcf(
    xml,
    *,
    force_contacts: bool = False,
    contact_stiffness: float = 5_000.0,
    contact_damping: float = 100.0,
    friction: Optional[float] = None,
    **model_overrides,
) -> MjcfImport:
    """Translate a single-robot MJCF document into an engine Model.

    Args:
      xml: MJCF XML string, a path to an XML file (detected by the
        absence of ``<``), or an already-compiled
        :class:`mujoco.MjModel` (for filling runtime-settable assets
        like ``hfield_data`` before importing).
      force_contacts: import contact geoms even when the MJCF declares
        no z = 0 world plane.
      contact_stiffness / contact_damping: engine penalty-contact
        parameters (MuJoCo's solref/solimp constraint model has no
        direct equivalent).
      friction: contact friction coefficient; defaults to the first
        imported contact geom's MJCF sliding friction.
      **model_overrides: forwarded to :class:`Model` (e.g.
        ``friction_vel``, ``max_contact_force``, ``limit_stiffness``).

    Raises ``ValueError`` for multi-tree worlds — use
    :func:`from_mjcf_scene` for robot-plus-object scenes.
    """
    trees, cross_pairs = _translate(
        xml,
        force_contacts=force_contacts,
        contact_stiffness=contact_stiffness,
        contact_damping=contact_damping,
        friction=friction,
        **model_overrides,
    )
    if len(trees) != 1:
        raise ValueError(
            f"MJCF contains {len(trees)} kinematic trees; use "
            "from_mjcf_scene for multi-tree worlds"
        )
    return trees[0]


def from_mjcf_scene(
    xml,
    *,
    force_contacts: bool = False,
    contact_stiffness: float = 5_000.0,
    contact_damping: float = 100.0,
    friction: Optional[float] = None,
    **model_overrides,
) -> MjcfSceneImport:
    """Translate a multi-tree MJCF world (robot + objects) into a
    :class:`~nnx_ppo_tpu_torch.physics.scene.Scene`.

    Each jointed subtree hanging off the world becomes its own engine
    :class:`Model`; ``<pair>`` elements between geoms of different
    trees become the scene's cross-tree contact pairs (within one tree
    they stay model collision pairs). Same subset rules as
    :func:`from_mjcf`."""
    from nnx_ppo_tpu_torch.physics.scene import Scene

    trees, cross_pairs = _translate(
        xml,
        force_contacts=force_contacts,
        contact_stiffness=contact_stiffness,
        contact_damping=contact_damping,
        friction=friction,
        **model_overrides,
    )
    scene = Scene(
        models=tuple(t.model for t in trees), pairs=tuple(cross_pairs)
    )
    return MjcfSceneImport(
        scene=scene,
        qpos0s=tuple(t.qpos0 for t in trees),
        imports=tuple(trees),
    )


_MJ_GEOM_CAPSULE = 3


def _translate(
    xml,
    *,
    force_contacts: bool,
    contact_stiffness: float,
    contact_damping: float,
    friction: Optional[float],
    **model_overrides,
):
    """Shared MJCF translation: returns ``(list[MjcfImport] per tree,
    cross-tree scene pairs)``."""
    import mujoco

    if isinstance(xml, str):
        m = (
            mujoco.MjModel.from_xml_string(xml)
            if "<" in xml
            else mujoco.MjModel.from_xml_path(xml)
        )
    else:
        # A precompiled MjModel — lets callers fill runtime-settable
        # assets (hfield_data) before importing.
        m = xml

    if abs(m.opt.gravity[0]) > 1e-12 or abs(m.opt.gravity[1]) > 1e-12:
        raise ValueError("engine gravity must be along z")
    if (
        m.opt.density != 0.0
        or m.opt.viscosity != 0.0
        or np.any(np.asarray(m.opt.wind) != 0.0)
    ):
        raise ValueError(
            "MJCF uses MuJoCo's fluid model (density/viscosity/wind), "
            "which the engine does not implement — the imported "
            "dynamics would silently lack the drag forces"
        )
    gravity = float(m.opt.gravity[2])

    def body_name(b: int) -> str:
        return mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, b) or f"body{b}"

    def geom_label(g: int) -> str:
        return mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_GEOM, g) or f"geom{g}"

    # ------------------------------------------------------------------
    # Pass 1 — frames. For each mj body b: host[b] = our body its
    # content lands on (welds merge into their jointed ancestor;
    # _WORLD for static scenery), and (W_R, W_t)[b] mapping b's mj
    # frame into that host's OUR frame (parent-aligned at the joint
    # anchor). MuJoCo guarantees parentid < id, so one forward pass.
    # ------------------------------------------------------------------
    nb = m.nbody
    host = [_WORLD] * nb
    W_R = [np.eye(3)] * nb
    W_t = [np.zeros(3)] * nb

    our_mj_body: list[int] = []  # our GLOBAL index → mj body id
    parent_our: list[int] = []
    tree_of: list[int] = []  # our global index → tree id
    joint_types: list[str] = []
    joint_axes: list[np.ndarray] = []
    joint_positions: list[np.ndarray] = []
    joint_ids: list[int] = []
    our_W_R: list[np.ndarray] = []  # per our body: its own frame unroll
    synthetic: list[bool] = []  # True = massless multi-joint link

    for b in range(1, nb):
        p = m.body_parentid[b]
        R_pb = _quat_to_mat(m.body_quat[b])
        # b's mj frame expressed in the parent's HOST our frame (or the
        # world frame while no jointed ancestor exists yet).
        R_in_host = W_R[p] @ R_pb
        t_in_host = W_R[p] @ m.body_pos[b] + W_t[p]

        if m.body_jntnum[b] == 0:  # weld
            host[b] = host[p]
            W_R[b], W_t[b] = R_in_host, t_in_host
            continue

        # A body with k joints decomposes into k chained engine bodies:
        # MuJoCo composes stacked joints in DECLARATION order (first
        # joint outermost — empirically pinned in tests/test_torch_mjcf.py),
        # so joints 0..k−2 ride on massless synthetic links and the
        # last carries the body's content. All axes/anchors are in the
        # (single) mj body frame, which every synthetic link shares at
        # q = 0, so the same per-joint recurrence applies with
        # identity body offsets after the first.
        k = int(m.body_jntnum[b])
        parent_host = host[p]
        R_cur, t_cur = R_in_host, t_in_host
        for t in range(k):
            j = int(m.body_jntadr[b]) + t
            jtype = _JOINT_TYPE[int(m.jnt_type[j])]
            oi = len(our_mj_body)
            our_mj_body.append(b)
            synthetic.append(t < k - 1)
            if jtype == FREE:
                if k > 1:
                    raise ValueError(
                        "free joint cannot share a body with other joints"
                    )
                if parent_host != _WORLD:
                    raise ValueError("free joint must be on a base body")
                # The free pose is STATE: the world-weld offset and
                # body_quat live in qpos0 (mujoco composes them there),
                # so the our frame coincides with the mj body frame.
                A = np.eye(3)
                W_t_b = np.zeros(3)
                parent_our.append(_WORLD)
                joint_axes.append(np.zeros(3))
                joint_positions.append(np.zeros(3))
            else:
                anchor = m.jnt_pos[j].copy()
                ref = (
                    float(m.qpos0[int(m.jnt_qposadr[j])])
                    if jtype in (HINGE, SLIDE)
                    else 0.0
                )
                parent_our.append(parent_host)
                # Our origin = joint anchor; our axes = parent-host
                # axes. Content coords: x_our = A @ (x_mj − anchor).
                jpos = t_cur + R_cur @ anchor
                if jtype == HINGE and ref != 0.0:
                    # MuJoCo rotates by (q − ref); the engine by q.
                    # rot(axis, q − ref) = rot(axis, −ref)·rot(axis, q):
                    # the constant rot(axis, −ref) folds into the frame
                    # unroll like any body_quat (it fixes the axis and
                    # the anchor, so jpos and the axis are unchanged).
                    a = m.jnt_axis[j] / np.linalg.norm(m.jnt_axis[j])
                    K = np.array(
                        [
                            [0.0, -a[2], a[1]],
                            [a[2], 0.0, -a[0]],
                            [-a[1], a[0], 0.0],
                        ]
                    )
                    A = R_cur @ (
                        np.eye(3)
                        - np.sin(ref) * K
                        + (1.0 - np.cos(ref)) * (K @ K)
                    )  # R_cur · rot(axis, −ref)
                else:
                    A = R_cur
                if jtype == SLIDE and ref != 0.0:
                    # MuJoCo translates by (q − ref): shift the anchor
                    # back by ref along the (parent-frame) axis.
                    jpos = jpos - ref * (R_cur @ m.jnt_axis[j])
                joint_positions.append(jpos)
                W_t_b = -A @ anchor
                joint_axes.append(A @ m.jnt_axis[j])
            tree_of.append(
                tree_of[parent_our[-1]]
                if parent_our[-1] != _WORLD
                else (max(tree_of) + 1 if tree_of else 0)
            )
            joint_types.append(jtype)
            joint_ids.append(j)
            our_W_R.append(A)
            # Chain: the next stacked joint hangs off this our body,
            # with the mj body frame re-expressed in ITS coordinates.
            parent_host = oi
            R_cur, t_cur = A, W_t_b
        host[b] = parent_host  # content lands on the last link
        W_R[b], W_t[b] = R_cur, t_cur

    n_our = len(our_mj_body)
    if n_our == 0:
        raise ValueError("MJCF contains no jointed bodies")
    n_trees = max(tree_of) + 1

    # ------------------------------------------------------------------
    # Pass 2 — inertia: combine every mj body's inertia into its host
    # (parallel-axis), expressed in the host's our frame.
    # ------------------------------------------------------------------
    parts: list[list] = [[] for _ in range(n_our)]  # (mass, com, I)
    for b in range(1, nb):
        if host[b] == _WORLD or m.body_mass[b] <= 0:
            continue
        com = W_R[b] @ m.body_ipos[b] + W_t[b]
        R_i = W_R[b] @ _quat_to_mat(m.body_iquat[b])
        I = R_i @ np.diag(m.body_inertia[b]) @ R_i.T
        parts[host[b]].append((float(m.body_mass[b]), com, I))

    mass = np.zeros(n_our)
    com = np.zeros((n_our, 3))
    inertia = np.zeros((n_our, 3, 3))
    for oi, plist in enumerate(parts):
        mtot = sum(p[0] for p in plist)
        mass[oi] = mtot
        if mtot <= 0:
            continue
        c = sum(p[0] * p[1] for p in plist) / mtot
        com[oi] = c
        I = np.zeros((3, 3))
        for mk, ck, Ik in plist:
            d = ck - c
            I += Ik + mk * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        inertia[oi] = I

    # ------------------------------------------------------------------
    # Pass 3 — geoms. Ground-plane detection, contact spheres (capsules
    # import as a sphere at each cap center), explicit pairs.
    # ------------------------------------------------------------------
    has_ground = False
    terrain = None
    skipped: list[str] = []
    geom_map: dict[int, list[int]] = {}  # mj geom id → our GLOBAL slots
    geom_body: list[int] = []  # global our-body index
    geom_offset: list[np.ndarray] = []
    geom_radius: list[float] = []
    geom_names: list[str] = []
    default_friction: Optional[float] = None
    for g in range(m.ngeom):
        b = int(m.geom_bodyid[g])
        gtype = int(m.geom_type[g])
        if gtype == _MJ_GEOM_HFIELD and host[b] == _WORLD:
            # World heightfield → bilinear HeightGrid terrain (axis-
            # aligned only: the engine's terrain is a function of world
            # xy). MuJoCo layout: rows along y, cols along x, heights
            # normalized to [0, 1] scaled by the hfield's z_top.
            from nnx_ppo_tpu_torch.physics.terrain import HeightGrid

            R_g = W_R[b] @ _quat_to_mat(m.geom_quat[g])
            pos = W_R[b] @ m.geom_pos[g] + W_t[b]
            if terrain is not None or not np.allclose(
                R_g, np.eye(3), atol=1e-9
            ):
                skipped.append(geom_label(g))
                continue
            hid = int(m.geom_dataid[g])
            nrow = int(m.hfield_nrow[hid])
            ncol = int(m.hfield_ncol[hid])
            if nrow < 2 or ncol < 2:
                raise ValueError(
                    f"hfield {geom_label(g)!r} is {nrow}x{ncol}; the "
                    "HeightGrid terrain needs at least 2x2 samples"
                )
            rx, ry, z_top, _ = (float(v) for v in m.hfield_size[hid])
            adr = int(m.hfield_adr[hid])
            rows = np.asarray(
                m.hfield_data[adr : adr + nrow * ncol], np.float64
            ).reshape(nrow, ncol)
            terrain = HeightGrid(
                data=rows.T * z_top + pos[2],  # [ncol(x), nrow(y)]
                x0=float(pos[0] - rx),
                y0=float(pos[1] - ry),
                dx=2.0 * rx / (ncol - 1),
                dy=2.0 * ry / (nrow - 1),
            )
            has_ground = True
            continue
        if gtype == _MJ_GEOM_PLANE and host[b] == _WORLD:
            # World plane: representable iff it is the engine's z = 0
            # ground (world z-normal through the origin height).
            z_world = (W_R[b] @ _quat_to_mat(m.geom_quat[g]))[:, 2]
            pos_world = W_R[b] @ m.geom_pos[g] + W_t[b]
            if (
                np.allclose(z_world, [0.0, 0.0, 1.0], atol=1e-9)
                and abs(pos_world[2]) < 1e-9
            ):
                has_ground = True
            else:
                skipped.append(geom_label(g))
            continue
        if host[b] == _WORLD:
            skipped.append(geom_label(g))
            continue
        if gtype == _MJ_GEOM_SPHERE:
            centers = [m.geom_pos[g]]
            names = [geom_label(g)]
        elif gtype == _MJ_GEOM_CAPSULE:
            # Two-sphere approximation: one contact sphere per cap
            # center (the segment axis is the geom frame's z).
            axis_z = _quat_to_mat(m.geom_quat[g])[:, 2]
            half = float(m.geom_size[g, 1])
            centers = [
                m.geom_pos[g] + half * axis_z,
                m.geom_pos[g] - half * axis_z,
            ]
            names = [f"{geom_label(g)}_cap0", f"{geom_label(g)}_cap1"]
        else:
            skipped.append(geom_label(g))
            continue
        geom_map[g] = []
        for cpos, nm in zip(centers, names):
            geom_map[g].append(len(geom_body))
            geom_body.append(host[b])
            geom_offset.append(W_R[b] @ cpos + W_t[b])
            geom_radius.append(float(m.geom_size[g, 0]))
            geom_names.append(nm)
        if default_friction is None:
            default_friction = float(m.geom_friction[g, 0])

    if not has_ground and not force_contacts:
        # No representable floor: a contact sphere would collide with
        # the engine's implicit z = 0 ground that the MJCF never had.
        # Explicit <pair> contacts would silently vanish with their
        # geoms — refuse instead, the user must opt in.
        if m.npair and any(
            int(m.pair_geom1[k]) in geom_map
            or int(m.pair_geom2[k]) in geom_map
            for k in range(m.npair)
        ):
            raise ValueError(
                "MJCF declares <pair> contacts but no z = 0 ground "
                "plane; pass force_contacts=True to import the contact "
                "geoms (they will also collide with the engine's "
                "implicit z = 0 ground)"
            )
        skipped.extend(geom_names)
        geom_map.clear()
        geom_body, geom_offset, geom_radius, geom_names = [], [], [], []

    # Explicit <pair> elements: every (our slot, our slot) combination
    # of the two geoms' imported spheres (capsules contribute two).
    pair_slots: list[tuple[int, int]] = []
    for k in range(m.npair):
        ga, gb = int(m.pair_geom1[k]), int(m.pair_geom2[k])
        for sa in geom_map.get(ga, ()):
            for sb in geom_map.get(gb, ()):
                pair_slots.append((sa, sb))

    # ------------------------------------------------------------------
    # Pass 4 — split by tree, build Models + qpos0s.
    # ------------------------------------------------------------------
    fric = (
        friction
        if friction is not None
        else (default_friction if default_friction is not None else 0.8)
    )
    tree_imports: list[MjcfImport] = []
    body_local: dict[int, int] = {}  # global our index → local index
    geom_local: dict[int, tuple[int, int]] = {}  # global slot → (tree, local)
    for t in range(n_trees):
        bodies = [oi for oi in range(n_our) if tree_of[oi] == t]
        for li, oi in enumerate(bodies):
            body_local[oi] = li
        t_parent = tuple(
            -1 if parent_our[oi] == _WORLD else body_local[parent_our[oi]]
            for oi in bodies
        )
        damping: list[float] = []
        armature: list[float] = []
        lower: list[float] = []
        upper: list[float] = []
        spring_k: list[float] = []
        spring_ref: list[float] = []
        qpos0: list[float] = []
        for oi in bodies:
            j = joint_ids[oi]
            jtype = joint_types[oi]
            nvj, nqj = _NV[jtype], _NQ[jtype]
            dof0 = int(m.jnt_dofadr[j])
            q0 = int(m.jnt_qposadr[j])
            d = list(m.dof_damping[dof0 : dof0 + nvj])
            a = list(m.dof_armature[dof0 : dof0 + nvj])
            if jtype == FREE:
                # MuJoCo free dof order is [v(3), ω(3)]; engine is
                # [ω(3), v(3)].
                d = d[3:] + d[:3]
                a = a[3:] + a[:3]
            damping.extend(d)
            armature.extend(a)
            if jtype in (HINGE, SLIDE) and bool(m.jnt_limited[j]):
                lower.append(float(m.jnt_range[j, 0]))
                upper.append(float(m.jnt_range[j, 1]))
            else:
                lower.extend([-np.inf] * nvj)
                upper.extend([np.inf] * nvj)
            if jtype in (HINGE, SLIDE):
                spring_k.append(float(m.jnt_stiffness[j]))
                spring_ref.append(float(m.qpos_spring[q0]))
            else:
                if float(m.jnt_stiffness[j]) != 0.0:
                    raise ValueError(
                        f"joint stiffness on a {jtype} joint is not "
                        "supported (1-dof joint springs only)"
                    )
                spring_k.extend([0.0] * nvj)
                spring_ref.extend([0.0] * nvj)
            seg = np.asarray(m.qpos0[q0 : q0 + nqj], np.float64)
            if jtype == BALL:
                # Conjugate the state quaternion into our-frame axes.
                qA = _mat_to_quat(our_W_R[oi])
                qAinv = qA * np.array([1.0, -1.0, -1.0, -1.0])
                seg = _quat_mul(_quat_mul(qA, seg), qAinv)
            qpos0.extend(seg.tolist())

        t_geoms = [
            s for s in range(len(geom_body)) if tree_of[geom_body[s]] == t
        ]
        for li, s in enumerate(t_geoms):
            geom_local[s] = (t, li)
        t_pairs = [
            (geom_local[sa][1], geom_local[sb][1])
            for sa, sb in pair_slots
            if tree_of[geom_body[sa]] == t and tree_of[geom_body[sb]] == t
        ]

        model = Model(
            parent=t_parent,
            joint_type=tuple(joint_types[oi] for oi in bodies),
            joint_axis=np.asarray(
                [joint_axes[oi] for oi in bodies], np.float64
            ),
            joint_pos=np.asarray(
                [joint_positions[oi] for oi in bodies], np.float64
            ),
            mass=mass[bodies],
            com=com[bodies],
            inertia=inertia[bodies],
            geom_body=tuple(body_local[geom_body[s]] for s in t_geoms),
            geom_offset=(
                np.asarray([geom_offset[s] for s in t_geoms], np.float64)
                if t_geoms
                else np.zeros((0, 3))
            ),
            geom_radius=np.asarray([geom_radius[s] for s in t_geoms]),
            damping=np.asarray(damping),
            armature=np.asarray(armature),
            joint_lower=np.asarray(lower),
            joint_upper=np.asarray(upper),
            spring_stiffness=np.asarray(spring_k),
            spring_ref=np.asarray(spring_ref),
            pair_geom_a=tuple(pa for pa, _ in t_pairs),
            pair_geom_b=tuple(pb for _, pb in t_pairs),
            gravity=gravity,
            contact_stiffness=contact_stiffness,
            contact_damping=contact_damping,
            friction=fric,
            **model_overrides,
        )
        # Joint actuators (metadata for envs): engine dof = this tree's
        # dof cursor at the actuated joint.
        dof_start = {}
        cursor = 0
        ball_rots = []
        for oi in bodies:
            dof_start[joint_ids[oi]] = cursor
            if joint_types[oi] == BALL:
                R = our_W_R[oi]
                if not np.allclose(R, np.eye(3), atol=1e-12):
                    ball_rots.append((cursor, R.copy()))
            cursor += _NV[joint_types[oi]]
        t_actuators = []
        for u in range(m.nu):
            if int(m.actuator_trntype[u]) != 0:  # joint transmission only
                continue
            j = int(m.actuator_trnid[u, 0])
            if j not in dof_start:
                continue
            gainprm = m.actuator_gainprm[u]
            biasprm = m.actuator_biasprm[u]
            kind, gear, kp, kv = "other", float(m.actuator_gear[u, 0]), 0.0, 0.0
            if int(m.actuator_biastype[u]) == 0 and gainprm[0] == 1.0:
                kind = "motor"
            elif int(m.actuator_biastype[u]) == 1 and biasprm[1] < 0:
                kind = "position"
                kp, kv = float(gainprm[0]), float(-biasprm[2])
            elif int(m.actuator_biastype[u]) == 1 and biasprm[2] < 0:
                kind = "velocity"
                kv = float(-biasprm[2])
            t_actuators.append(
                ActuatorSpec(
                    name=(
                        mujoco.mj_id2name(
                            m, mujoco.mjtObj.mjOBJ_ACTUATOR, u
                        )
                        or f"actuator{u}"
                    ),
                    joint=(
                        mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_JOINT, j)
                        or f"joint{j}"
                    ),
                    dof=dof_start[j],
                    kind=kind,
                    gear=gear,
                    kp=kp,
                    kv=kv,
                    ctrlrange=(
                        (
                            float(m.actuator_ctrlrange[u, 0]),
                            float(m.actuator_ctrlrange[u, 1]),
                        )
                        if bool(m.actuator_ctrllimited[u])
                        else None
                    ),
                )
            )

        tree_imports.append(
            MjcfImport(
                model=model,
                qpos0=np.asarray(qpos0, np.float32),
                body_names=tuple(
                    # Synthetic multi-joint links carry the joint
                    # name (the body name goes to the content link).
                    (
                        mujoco.mj_id2name(
                            m, mujoco.mjtObj.mjOBJ_JOINT, joint_ids[oi]
                        )
                        or f"joint{joint_ids[oi]}"
                    )
                    if synthetic[oi]
                    else body_name(our_mj_body[oi])
                    for oi in bodies
                ),
                geom_names=tuple(geom_names[s] for s in t_geoms),
                skipped_geoms=tuple(skipped),
                has_ground=has_ground,
                actuators=tuple(t_actuators),
                terrain=terrain,
                ball_dof_rotations=tuple(ball_rots),
            )
        )

    cross_pairs = [
        (
            geom_local[sa][0],
            geom_local[sa][1],
            geom_local[sb][0],
            geom_local[sb][1],
        )
        for sa, sb in pair_slots
        if tree_of[geom_body[sa]] != tree_of[geom_body[sb]]
    ]
    return tree_imports, cross_pairs


# -- a saved import ------------------------------------------------------------
#
# Not in the JAX module: a machine without ``mujoco`` (the GPU machine of
# ``chip_smoke.py``) rebuilds an import from a ``.npz`` written where
# ``mujoco`` is installed. numpy only, no pickles.

_TUPLE_OF_INT_FIELDS = ("parent", "geom_body", "pair_geom_a", "pair_geom_b")
_ACTUATOR_FIELDS = ("name", "joint", "dof", "kind", "gear", "kp", "kv")


def save_import(imp: MjcfImport, path) -> None:
    """Write ``imp`` (every ``Model`` field, ``qpos0``, names, the
    actuator specs, the ball-dof rotations and a ``HeightGrid`` terrain)
    to the ``.npz`` file ``path``."""
    arrays = {f"model.{f.name}": np.asarray(getattr(imp.model, f.name))
              for f in dataclasses.fields(Model)}
    arrays.update({
        "qpos0": np.asarray(imp.qpos0),
        "body_names": np.asarray(imp.body_names, dtype=str),
        "geom_names": np.asarray(imp.geom_names, dtype=str),
        "skipped_geoms": np.asarray(imp.skipped_geoms, dtype=str),
        "has_ground": np.asarray(imp.has_ground),
        "ball_dofs": np.asarray([d for d, _ in imp.ball_dof_rotations], np.int64),
        "ball_rotations": np.asarray([R for _, R in imp.ball_dof_rotations],
                                     np.float64).reshape(-1, 3, 3),
    })
    for name in _ACTUATOR_FIELDS:
        arrays[f"actuator.{name}"] = np.asarray([getattr(a, name) for a in imp.actuators])
    arrays["actuator.ctrlrange"] = np.asarray(
        [a.ctrlrange if a.ctrlrange is not None else (np.nan, np.nan) for a in imp.actuators],
        np.float64,
    ).reshape(-1, 2)
    if imp.terrain is not None:
        grid = imp.terrain
        arrays["terrain.data"] = np.asarray(grid.data)
        arrays["terrain.origin_spacing"] = np.asarray([grid.x0, grid.y0, grid.dx, grid.dy])
    np.savez(path, **arrays)


def load_import(path) -> MjcfImport:
    """Rebuild the :class:`MjcfImport` that :func:`save_import` wrote, with
    numpy alone (no ``mujoco``)."""
    with np.load(path, allow_pickle=False) as z:
        fields = {}
        for f in dataclasses.fields(Model):
            value = z[f"model.{f.name}"]
            if value.dtype.kind == "U":
                fields[f.name] = tuple(str(x) for x in value)
            elif f.name in _TUPLE_OF_INT_FIELDS:
                fields[f.name] = tuple(int(x) for x in value)
            elif value.ndim == 0:
                fields[f.name] = float(value)
            else:
                fields[f.name] = value
        actuators = tuple(
            ActuatorSpec(
                name=str(z["actuator.name"][u]),
                joint=str(z["actuator.joint"][u]),
                dof=int(z["actuator.dof"][u]),
                kind=str(z["actuator.kind"][u]),
                gear=float(z["actuator.gear"][u]),
                kp=float(z["actuator.kp"][u]),
                kv=float(z["actuator.kv"][u]),
                ctrlrange=(
                    None if np.isnan(z["actuator.ctrlrange"][u]).any()
                    else tuple(float(x) for x in z["actuator.ctrlrange"][u])
                ),
            )
            for u in range(len(z["actuator.dof"]))
        )
        terrain = None
        if "terrain.data" in z:
            from nnx_ppo_tpu_torch.physics.terrain import HeightGrid

            x0, y0, dx, dy = (float(x) for x in z["terrain.origin_spacing"])
            terrain = HeightGrid(data=z["terrain.data"], x0=x0, y0=y0, dx=dx, dy=dy)
        return MjcfImport(
            model=Model(**fields),
            qpos0=z["qpos0"],
            body_names=tuple(str(x) for x in z["body_names"]),
            geom_names=tuple(str(x) for x in z["geom_names"]),
            skipped_geoms=tuple(str(x) for x in z["skipped_geoms"]),
            has_ground=bool(z["has_ground"]),
            actuators=actuators,
            terrain=terrain,
            ball_dof_rotations=tuple(
                (int(d), R) for d, R in zip(z["ball_dofs"], z["ball_rotations"])
            ),
        )
