"""The manipulation-scene control step: one CUDA kernel, its plain
PyTorch version, and the runner the envs call.

Port of ``nnx_ppo_tpu/physics/pallas_step.py:714-950``
(``pallas_scene_step``, ``make_scene_control_step_runner``). A scene is a
tuple of kinematic trees (FREE joints at roots, BALL, HINGE and SLIDE
joints anywhere) plus cross-tree sphere pairs ``(tree_a, geom_a, tree_b,
geom_b)``; a single general tree is a scene of one tree and no pairs. A
control step is ``n_substeps`` exact-dynamics substeps under constant
applied torques (``engine_soa_general.scene_substep_soa``: the factor of
``M + armature + dt·D`` is rebuilt from the current ``qpos`` at every
substep). The trees' states travel concatenated on the feature axis:
``qpos_cat[B, Σnq]``, ``qvel_cat[B, Σnv]``, ``tau_cat[B, Σnv]``.

* :func:`scene_step_plain` is the plain PyTorch version: the lane
  functions of ``engine_soa_general.py`` over the columns of the inputs.
  :func:`scene_step_cuda` launches the hand-written kernel of
  ``nnx_ppo_tpu_torch/csrc/scene_step.cu`` once per control step and counts
  its launches in ``scene_step_cuda.launches``.
* :func:`make_scene_control_step_runner` returns ``run(qpos_cat, qvel_cat,
  tau_cat) -> (qpos_cat', qvel_cat', normals)``. It dispatches by the
  tensors' device as ``ops/gae.py`` does: the kernel for CUDA tensors, the
  plain version for CPU tensors. There is no fallback: a CUDA tensor that
  the kernel cannot take, a failed build or a failed launch raises.

``normals[B, n_normals]`` are the contact normal forces of the last
substep: per tree (ground geoms, then the tree's own pairs) in tree order,
then the cross pairs. ``n_normals`` is at least 1: a scene without any
contact gets one zero column. (The JAX kernel pads its output to one row
in the same way, while the JAX per-env reference returns an empty vector;
both of the port's versions take the kernel's shape.)

Terrain: flat ground (``None``) or an analytic ``Terrain`` (wave sums
inside the kernel), for every tree. A ``HeightGrid`` is refused: its plane
sampler is built for one free base plus hinges. The JAX runner's
``custom_vmap``, ``custom_partitioning``, ``force_pallas`` and tile picking
have no counterpart: the batch dimension is written out and the kernel
masks the ragged edge, so any ``B`` works.

The kernel's array sizes (trees, bodies, ``Σnq``, ``Σnv``, the largest
tree's ``nv``, geoms, pairs, terrain waves) and its lanes per env are
``-D`` defines, so each scene size is one library; everything else about
the scene, with the schedules its lane groups walk (levels and contact
slots, ``cuda_step.tree_schedule`` and ``contact_schedule``), is a struct
filled here from the models and passed to the kernel by value. Where the
plain version folds two model constants in float64 before its first
float32 operation (a leaf body's rows of ``M``, pair radius sums, mean
pair parameters, outer products of hinge axes, ``dt·damping``), the struct
carries the folded constant, so that kernel and plain version round alike.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from nnx_ppo_tpu_torch.ops import cuda_build
from nnx_ppo_tpu_torch.physics.cuda_step import (
    KERNEL_FLAGS,
    contact_schedule,
    padded_schedule,
    tree_schedule,
)
from nnx_ppo_tpu_torch.physics.engine_soa_general import (
    _blocks_times_sp,
    _const_blocks,
    _s_cols,
    _sdot,
    scene_substep_soa,
    soa_general_unsupported_reason,
)
from nnx_ppo_tpu_torch.physics.model import BALL, FREE, HINGE, SLIDE, Model
from nnx_ppo_tpu_torch.physics.terrain import Terrain

# The kernel's joint-type codes (enum JointType of csrc/scene_step.cu).
JOINT_CODES = {FREE: 0, BALL: 1, HINGE: 2, SLIDE: 3}
# The -D defines, in the order scene_step_params_size reports them.
SIZE_NAMES = ("SS_NT", "SS_NB", "SS_NQ", "SS_NV", "SS_MV", "SS_NG", "SS_NP", "SS_NW", "SS_G")
# Lanes per env (a -D size that divides 32) and threads per block (a
# multiple of 32) of the scene kernel: the fastest pair of the sweep of
# ``chip_smoke.py --variants`` on the H100 (PERF.md).
SCENE_STEP_GROUP = 4
SCENE_STEP_THREADS = 64


class SceneStepPlan:
    """Everything about one scene configuration that does not depend on
    the state: the checks, the layout of the concatenated state and of
    the normals, and (built on first CUDA use) the kernel's library and
    the packed scene struct. The plan is the (callable) runner."""

    def __init__(self, models: Sequence[Model], pairs: Sequence[tuple[int, int, int, int]],
                 dt: float, n_substeps: int, terrain: Optional[Terrain] = None):
        self.models = tuple(models)
        self.pairs = tuple(tuple(int(x) for x in pair) for pair in pairs)
        for m in self.models:
            reason = soa_general_unsupported_reason(m)
            if reason is not None:
                raise ValueError(f"scene kernel unsupported: {reason}")
        if terrain is not None and not isinstance(terrain, Terrain):
            raise ValueError(
                "scene kernel unsupported: the scene control step takes the flat ground "
                "or an analytic Terrain (in-kernel wave sums) only, got "
                f"{type(terrain).__name__}"
            )
        self.dt = float(dt)
        self.n_substeps = int(n_substeps)
        self.terrain = terrain
        self.nq = sum(m.nq for m in self.models)
        self.nv = sum(m.nv for m in self.models)
        self.n_contacts = sum(
            len(m.geom_body) + len(m.pair_geom_a) for m in self.models
        ) + len(self.pairs)
        self.n_normals = max(self.n_contacts, 1)
        # The kernel's launch: lanes per env and threads per block (set
        # before the first CUDA call to try others).
        self.group_size = SCENE_STEP_GROUP
        self.threads_per_block = SCENE_STEP_THREADS

    # -- shapes ------------------------------------------------------------

    def check(self, qpos_cat, qvel_cat, tau_cat) -> int:
        """Validate one call's arguments; returns the batch size."""
        if qpos_cat.ndim != 2 or qpos_cat.shape[1] != self.nq:
            raise ValueError(f"qpos_cat must be [B, {self.nq}], got {tuple(qpos_cat.shape)}")
        B = qpos_cat.shape[0]
        for name, x in (("qvel_cat", qvel_cat), ("tau_cat", tau_cat)):
            if tuple(x.shape) != (B, self.nv) or x.device != qpos_cat.device:
                raise ValueError(
                    f"{name}: expected shape {(B, self.nv)} on {qpos_cat.device}, got "
                    f"{tuple(x.shape)} on {x.device}"
                )
        return B

    def _split(self, cat: torch.Tensor, widths: Sequence[int]) -> tuple:
        """Per-tree lane tuples of a concatenated ``[B, Σwidth]`` tensor."""
        lanes = cat.to(torch.float32).unbind(1)
        out, cursor = [], 0
        for width in widths:
            out.append(tuple(lanes[cursor:cursor + width]))
            cursor += width
        return tuple(out)

    # -- the plain version ---------------------------------------------------

    def plain(self, qpos_cat, qvel_cat, tau_cat):
        B = self.check(qpos_cat, qvel_cat, tau_cat)
        with torch.no_grad():
            qposs = self._split(qpos_cat, [m.nq for m in self.models])
            qvels = self._split(qvel_cat, [m.nv for m in self.models])
            taus = self._split(tau_cat, [m.nv for m in self.models])
            tree_normals: tuple = tuple(() for _ in self.models)
            cross: tuple = ()
            for _ in range(self.n_substeps):
                qposs, qvels, tree_normals, cross = scene_substep_soa(
                    self.models, self.pairs, qposs, qvels, taus, self.dt, terrain=self.terrain
                )
            flat = [fn for per_tree in tree_normals for fn in per_tree] + list(cross)
            normals = (
                torch.stack(flat, dim=1) if flat
                else torch.zeros((B, 1), dtype=torch.float32, device=qpos_cat.device)
            )
            return (
                torch.stack([q for tree in qposs for q in tree], dim=1),
                torch.stack([q for tree in qvels for q in tree], dim=1),
                normals,
            )

    # -- the kernel ----------------------------------------------------------

    @property
    def sizes(self) -> dict[str, int]:
        """The ``-D`` defines that size the kernel's arrays, and its lanes
        per env."""
        return {
            "SS_NT": len(self.models),
            "SS_NB": sum(m.n_bodies for m in self.models),
            "SS_NQ": self.nq,
            "SS_NV": self.nv,
            "SS_MV": max(m.nv for m in self.models),
            "SS_NG": sum(len(m.geom_body) for m in self.models),
            "SS_NP": sum(len(m.pair_geom_a) for m in self.models) + len(self.pairs),
            "SS_NW": 0 if self.terrain is None else len(self.terrain.amplitudes),
            "SS_G": self.group_size,
        }

    @property
    def kernel_spec(self) -> tuple[str, tuple[str, ...]]:
        """What ``cuda_build.build`` takes to build this plan's library."""
        return "scene_step", cuda_build.define_flags(self.sizes) + KERNEL_FLAGS

    @functools.cached_property
    def _params(self) -> ctypes.Structure:
        return pack_scene_params(self)

    @functools.cached_property
    def _entry_point(self):
        """``scene_step_forward`` of this plan's library, checked against
        this plan's struct: a library built for other sizes must not be
        launched."""
        lib = cuda_build.load(*self.kernel_spec)
        built_for = (ctypes.c_int * len(SIZE_NAMES))()
        lib.scene_step_params_size.argtypes = [ctypes.c_void_p]
        lib.scene_step_params_size.restype = ctypes.c_int
        size = lib.scene_step_params_size(built_for)
        want = [self.sizes[k] for k in SIZE_NAMES]
        if size != ctypes.sizeof(self._params) or list(built_for) != want:
            raise RuntimeError(
                f"scene_step library was built for sizes {list(built_for)} "
                f"(struct of {size} bytes); this plan needs {want} "
                f"({ctypes.sizeof(self._params)} bytes)"
            )
        fn = lib.scene_step_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p] + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        return fn

    def shared_memory_bytes(self) -> int:
        """Dynamic shared memory of one block at this plan's launch (the
        scene struct and ``threads_per_block / group_size`` envs), from the
        library."""
        self._entry_point  # builds and checks the library
        smem = cuda_build.load(*self.kernel_spec).scene_step_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_longlong
        return int(smem(self.threads_per_block))

    def cuda(self, qpos_cat, qvel_cat, tau_cat):
        B = self.check(qpos_cat, qvel_cat, tau_cat)
        device = qpos_cat.device
        if device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {device}")
        if B >= 2**31 // max(self.nq, self.n_normals, self.group_size):
            raise ValueError(f"B = {B} is too large for the kernel")
        qpos_out = torch.empty((B, self.nq), dtype=torch.float32, device=device)
        qvel_out = torch.empty((B, self.nv), dtype=torch.float32, device=device)
        normals_out = torch.empty((B, self.n_normals), dtype=torch.float32, device=device)
        if B == 0:
            return qpos_out, qvel_out, normals_out
        with torch.no_grad():
            ins = [x.detach().to(torch.float32).contiguous()
                   for x in (qpos_cat, qvel_cat, tau_cat)]
        stream = torch.cuda.current_stream(device)
        # The entry point sets the calling thread's device to the tensors';
        # the guard gives the caller's current device back after it.
        with torch.cuda.device(device):
            err = self._entry_point(
                *(x.data_ptr() for x in ins),
                qpos_out.data_ptr(), qvel_out.data_ptr(), normals_out.data_ptr(),
                B, ctypes.addressof(self._params), self.threads_per_block,
                stream.device.index, stream.cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"scene_step kernel launch failed: cudaError_t {err}")
        cuda_build.count_launch(scene_step_cuda, device)
        return qpos_out, qvel_out, normals_out

    def __call__(self, qpos_cat, qvel_cat, tau_cat):
        """Dispatch by device: the kernel for CUDA tensors, the plain
        version for CPU tensors; any other device raises."""
        device = qpos_cat.device
        if device.type == "cuda":
            return self.cuda(qpos_cat, qvel_cat, tau_cat)
        if device.type == "cpu":
            return self.plain(qpos_cat, qvel_cat, tau_cat)
        raise ValueError(f"the scene control step has no implementation for device {device}")


def _mean_pair_parameters(ma: Model, mb: Model) -> dict[str, float]:
    """A sphere pair's contact parameters between trees ``ma`` and ``mb``
    (the same tree twice for a tree's own pair), folded in float64 as
    ``engine_soa_general._sphere_pair_soa`` folds them."""
    return {
        "pair_stiffness": 0.5 * (ma.contact_stiffness + mb.contact_stiffness),
        "pair_damping": 0.5 * (ma.contact_damping + mb.contact_damping),
        "pair_friction": 0.5 * (ma.friction + mb.friction),
        "pair_friction_vel": max(ma.friction_vel, mb.friction_vel),
        "pair_max_force": min(ma.max_contact_force, mb.max_contact_force),
    }


def pack_scene_params(plan: SceneStepPlan) -> ctypes.Structure:
    """The kernel's scene struct (``struct SceneParams`` of
    ``csrc/scene_step.cu``: same members, same order, all 4 bytes wide),
    filled from the plan. Body, dof, geom and qpos indices become global
    (into the concatenated scene)."""
    models, dt = plan.models, plan.dt
    sizes = plan.sizes
    nw = sizes["SS_NW"]
    f32, i32 = ctypes.c_float, ctypes.c_int

    def at_least_1(n: int) -> int:
        return max(n, 1)

    tree = {k: [] for k in (
        "tree_body_start", "tree_body_end", "tree_v_start", "tree_nv", "gravity_up",
        "contact_stiffness", "contact_damping", "friction", "friction_vel",
        "max_contact_force", "limit_stiffness", "limit_damping", "has_limits", "has_springs",
    )}
    body = {k: [] for k in (
        "body_tree", "parent", "joint_type", "q_start", "v_start", "n_dof", "is_leaf", "fold_c",
        "joint_axis", "axis_outer", "joint_pos", "mass", "com", "inertia",
        "blk_a", "blk_b", "blk_c",
    )}
    dof = {k: [] for k in (
        "s_col", "leaf_f", "leaf_m", "damping", "dt_damping", "armature", "lower", "upper",
        "spring_k", "spring_ref",
    )}
    geom = {k: [] for k in ("geom_body", "geom_tree", "geom_slot", "geom_offset", "geom_radius")}
    pair = {k: [] for k in (
        "pair_a", "pair_b", "pair_slot", "pair_radius_sum", "pair_stiffness", "pair_damping",
        "pair_friction", "pair_friction_vel", "pair_max_force",
    )}
    geom_start = []  # per tree: its first geom's global index
    slot = 0
    b0 = q0 = v0 = 0
    for t, m in enumerate(models):
        nb, nv = m.n_bodies, m.nv
        has_limits = m.joint_lower.size > 0
        has_springs = m.spring_stiffness.size > 0
        tree["tree_body_start"].append(b0)
        tree["tree_body_end"].append(b0 + nb)
        tree["tree_v_start"].append(v0)
        tree["tree_nv"].append(nv)
        tree["gravity_up"].append(-float(m.gravity))
        for name in ("contact_stiffness", "contact_damping", "friction", "friction_vel",
                     "max_contact_force", "limit_stiffness", "limit_damping"):
            tree[name].append(float(getattr(m, name)))
        tree["has_limits"].append(int(has_limits))
        tree["has_springs"].append(int(has_springs))

        # Lin-lin inertia blocks: a SLIDE child's block is a constant in
        # the parent frame too, and the plain version adds two constant
        # blocks in float64. Fold those here, children before parents.
        blocks = [_const_blocks(m, i) for i in range(nb)]
        c_block = [list(blk[2]) for blk in blocks]
        c_is_constant = [True] * nb
        fold_c = [0] * nb
        for i in reversed(range(nb)):
            p = m.parent[i]
            if p < 0:
                continue
            if m.joint_type[i] == SLIDE and c_is_constant[i] and c_is_constant[p]:
                c_block[p] = [x + y for x, y in zip(c_block[p], c_block[i])]
                fold_c[i] = 1
            else:
                c_is_constant[p] = False
        children = [0] * nb
        for p in m.parent:
            if p >= 0:
                children[p] += 1

        qslices, vslices = m.qpos_slices(), m.dof_slices()
        for i in range(nb):
            axis = [float(x) for x in m.joint_axis[i]]
            body["body_tree"].append(t)
            body["parent"].append(m.parent[i] + b0 if m.parent[i] >= 0 else -1)
            body["joint_type"].append(JOINT_CODES[m.joint_type[i]])
            body["q_start"].append(q0 + qslices[i][0])
            body["v_start"].append(v0 + vslices[i][0])
            body["n_dof"].append(vslices[i][1])
            body["is_leaf"].append(int(children[i] == 0))
            body["fold_c"].append(fold_c[i])
            body["joint_axis"].append(axis)
            body["axis_outer"].append([a * b for a in axis for b in axis])
            body["joint_pos"].append(np.asarray(m.joint_pos[i], np.float64))
            body["mass"].append(float(m.mass[i]))
            body["com"].append(np.asarray(m.com[i], np.float64))
            body["inertia"].append(np.asarray(m.inertia[i], np.float64).reshape(-1))
            body["blk_a"].append(blocks[i][0])
            body["blk_b"].append(blocks[i][1])
            body["blk_c"].append(c_block[i])

            # Per dof: the motion-subspace column and, for a leaf body
            # (constant inertia), I s and its row of M + armature + dt·D,
            # all folded in float64 as the plain version folds them.
            cols = _s_cols(m, i)
            vs, nd = vslices[i]
            for a in range(nd):
                k = vs + a
                leaf_f, leaf_m = [0.0] * 6, [0.0] * 6
                if children[i] == 0:
                    leaf_f = list(_blocks_times_sp(blocks[i], cols[a]))
                    for b in range(a + 1):
                        leaf_m[b] = _sdot(cols[b], leaf_f) or 0.0
                    leaf_m[a] = leaf_m[a] + float(m.armature[k])
                    if m.damping[k]:
                        leaf_m[a] = leaf_m[a] + float(dt * m.damping[k])
                dof["s_col"].append(list(cols[a]))
                dof["leaf_f"].append(leaf_f)
                dof["leaf_m"].append(leaf_m)
                dof["damping"].append(float(m.damping[k]))
                dof["dt_damping"].append(float(dt * m.damping[k]))
                dof["armature"].append(float(m.armature[k]))
                dof["lower"].append(float(m.joint_lower[k]) if has_limits else -np.inf)
                dof["upper"].append(float(m.joint_upper[k]) if has_limits else np.inf)
                dof["spring_k"].append(float(m.spring_stiffness[k]) if has_springs else 0.0)
                dof["spring_ref"].append(float(m.spring_ref[k]) if has_springs else 0.0)

        g0 = len(geom["geom_body"])
        geom_start.append(g0)
        for g, b in enumerate(m.geom_body):
            geom["geom_body"].append(b0 + int(b))
            geom["geom_tree"].append(t)
            geom["geom_slot"].append(slot)
            geom["geom_offset"].append(np.asarray(m.geom_offset[g], np.float64))
            geom["geom_radius"].append(float(m.geom_radius[g]))
            slot += 1
        for ga, gb in zip(m.pair_geom_a, m.pair_geom_b):
            pair["pair_a"].append(g0 + int(ga))
            pair["pair_b"].append(g0 + int(gb))
            pair["pair_slot"].append(slot)
            pair["pair_radius_sum"].append(float(m.geom_radius[ga]) + float(m.geom_radius[gb]))
            for name, value in _mean_pair_parameters(m, m).items():
                pair[name].append(value)
            slot += 1
        b0, q0, v0 = b0 + nb, q0 + m.nq, v0 + nv
    for ta, ga, tb, gb in plan.pairs:
        ma, mb = models[ta], models[tb]
        pair["pair_a"].append(geom_start[ta] + ga)
        pair["pair_b"].append(geom_start[tb] + gb)
        pair["pair_slot"].append(slot)
        pair["pair_radius_sum"].append(float(ma.geom_radius[ga]) + float(mb.geom_radius[gb]))
        for name, value in _mean_pair_parameters(ma, mb).items():
            pair[name].append(value)
        slot += 1
    assert slot == plan.n_contacts

    waves = plan.terrain if plan.terrain is not None else Terrain()
    directions = np.asarray(waves.directions, np.float64).reshape(nw, 2)
    amplitudes = np.asarray(waves.amplitudes, np.float64)
    frequencies = np.asarray(waves.frequencies, np.float64)
    int_members = {
        "tree_body_start", "tree_body_end", "tree_v_start", "tree_nv", "has_limits",
        "has_springs", "body_tree", "parent", "joint_type", "q_start", "v_start", "n_dof",
        "is_leaf", "fold_c", "geom_body", "geom_tree", "geom_slot", "pair_a", "pair_b",
        "pair_slot",
    }
    # (values, entries per row, rows the struct holds)
    n_geoms, n_pairs = sizes["SS_NG"], sizes["SS_NP"]
    rows_of = {}
    rows_of.update({k: len(models) for k in tree})
    rows_of.update({k: sizes["SS_NB"] for k in body})
    rows_of.update({k: sizes["SS_NV"] for k in dof})
    rows_of.update({k: at_least_1(n_geoms) for k in geom})
    rows_of.update({k: at_least_1(n_pairs) for k in pair})
    members = []
    for group in (tree, body, dof, geom, pair):
        for name, rows in group.items():
            members.append((name, i32 if name in int_members else f32, rows, rows_of[name]))
    width_of = {
        "joint_axis": 3, "axis_outer": 9, "joint_pos": 3, "com": 3, "inertia": 9, "blk_a": 9,
        "blk_b": 9, "blk_c": 9, "s_col": 6, "leaf_f": 6, "leaf_m": 6, "geom_offset": 3,
    }
    wave_members = [
        ("wave_amp", amplitudes), ("wave_freq", frequencies),
        ("wave_amp_freq", amplitudes * frequencies), ("wave_dx", directions[:, 0]),
        ("wave_dy", directions[:, 1]), ("wave_phase", np.asarray(waves.phases, np.float64)),
    ]
    for name, values in wave_members:
        members.append((name, f32, list(values), at_least_1(nw)))
    members.append(("slope", f32, [float(x) for x in waves.slope], 2))

    fields, values = [], {}
    for name, ctype, rows, n_rows in members:
        width = width_of.get(name, 1)
        flat = np.zeros(n_rows * width, np.float64)
        given = np.asarray(rows, np.float64).reshape(-1)
        if given.size > flat.size or given.size % width:
            raise ValueError(f"{name}: {given.size} values for {n_rows} rows of {width}")
        flat[:given.size] = given
        fields.append((name, ctype * flat.size))
        values[name] = (ctype, flat)
    scalars = [
        ("dt", f32, dt),
        ("n_substeps", i32, plan.n_substeps),
        ("terrain_mode", i32, 0 if plan.terrain is None else 1),
        ("n_normals", i32, plan.n_normals),
    ]
    fields.extend((name, ctype) for name, ctype, _ in scalars)
    nb = sizes["SS_NB"]
    schedule = padded_schedule(
        {
            **tree_schedule(body["parent"]),
            **contact_schedule(
                nb, geom["geom_body"], [geom["geom_body"][g] for g in pair["pair_a"]],
                [geom["geom_body"][g] for g in pair["pair_b"]],
            ),
        },
        {"level_start": nb + 1, "level_body": nb, "contact_start": nb + 1,
         "contact_slot": at_least_1(n_geoms + 2 * n_pairs)},
    )
    for name in ("level_start", "level_body", "contact_start", "contact_slot"):
        fields.append((name, i32 * len(schedule[name])))
        values[name] = (i32, np.asarray(schedule[name], np.float64))
    fields.append(("n_levels", i32))
    scalars.append(("n_levels", i32, schedule["n_levels"]))

    class SceneParams(ctypes.Structure):
        _fields_ = fields

    params = SceneParams()
    for name, (ctype, flat) in values.items():
        cast = int if ctype is i32 else float
        setattr(params, name, (ctype * flat.size)(*(cast(x) for x in flat)))
    for name, ctype, value in scalars:
        setattr(params, name, int(value) if ctype is i32 else float(value))
    return params


def scene_step_plain(models, pairs, qpos_cat, qvel_cat, tau_cat, dt: float, n_substeps: int,
                     terrain=None):
    """The plain PyTorch version of one scene control step:
    ``(qpos_cat[B, Σnq], qvel_cat[B, Σnv], tau_cat[B, Σnv]) -> (qpos_cat',
    qvel_cat', normals[B, n_normals])``, float32, no gradient."""
    return SceneStepPlan(models, pairs, dt, n_substeps, terrain).plain(qpos_cat, qvel_cat, tau_cat)


def scene_step_cuda(models, pairs, qpos_cat, qvel_cat, tau_cat, dt: float, n_substeps: int,
                    terrain=None):
    """One scene control step through the CUDA kernel, on the current
    stream (same signature as :func:`scene_step_plain`). A caller that
    steps repeatedly keeps a runner instead, so that the scene struct is
    packed once."""
    return SceneStepPlan(models, pairs, dt, n_substeps, terrain).cuda(qpos_cat, qvel_cat, tau_cat)


# Counted in SceneStepPlan.cuda, where the kernel launches.
cuda_build.counted(scene_step_cuda)


def make_scene_control_step_runner(models, pairs, dt: float, n_substeps: int,
                                   terrain=None) -> SceneStepPlan:
    """``run(qpos_cat[B, Σnq], qvel_cat[B, Σnv], tau_cat[B, Σnv]) ->
    (qpos_cat', qvel_cat', normals[B, n_normals])`` advancing a whole
    control step of a multi-tree scene (or of a single general tree:
    ``models`` of length 1, no pairs): one kernel launch per control step
    on CUDA tensors, the plain version on CPU tensors. Exact per-substep
    dynamics. Raises ``ValueError`` for a model the general SoA dynamics
    cannot run and for a terrain that is neither flat nor analytic."""
    return SceneStepPlan(models, pairs, dt, n_substeps, terrain)
