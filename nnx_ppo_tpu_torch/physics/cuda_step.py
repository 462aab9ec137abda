"""One control step of the legged-robot physics: CUDA kernel, plain
PyTorch version, and the runner the envs call.

Port of ``nnx_ppo_tpu/physics/pallas_step.py:226-629``
(``pallas_control_step`` and ``make_control_step_runner``). A control
step is the Cholesky factor of ``M + armature + dt·D`` built from the
pre-substep ``qpos`` (held over the step, or rebuilt at every substep
with ``exact``), then ``n_substeps`` SoA substeps; it returns the
integrated ``qpos``/``qvel`` and the contact normal forces of the last
substep (ground geoms first, then pairs).

* :func:`control_step_plain` is the plain PyTorch version: the lane
  functions of ``engine_soa.py`` over the columns of the ``[B, k]``
  inputs.
* :func:`control_step_cuda` launches the hand-written kernel
  ``nnx_ppo_tpu_torch/csrc/control_step.cu`` once per control step and
  counts its launches in ``control_step_cuda.launches``.
* :func:`make_control_step_runner` returns ``run(qpos, qvel, target[,
  extra])``, which dispatches by the tensors' device as ``ops/gae.py``
  does: the kernel for CUDA tensors, the plain version for CPU tensors.
  There is no fallback: a CUDA tensor that the kernel cannot take, a
  failed build or a failed launch raises.

``extra`` packs the per-env lanes ``[B, n_extra]``: the
domain-randomization scalars named by ``dr_fields`` (in that order),
then the 3 push-force lanes (``has_push``), then ``n_terrain_planes``
tangent-plane triples ``(c, gx, gy)``. The JAX runner's ``custom_vmap``,
``custom_partitioning`` and tile picking have no counterpart: the batch
dimension is written out and the kernel masks the ragged edge.

The kernel's source is one file. Its array sizes (bodies, geoms, pairs,
terrain waves) are ``-D`` defines, so each model size is one library;
everything else about the model (topology, inertias, geoms, gains,
terrain waves, feature switches) is a struct filled here from the
``Model`` and passed to the kernel by value.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from nnx_ppo_tpu_torch.ops import cuda_build
from nnx_ppo_tpu_torch.physics.engine_soa import (
    crba_chol_soa,
    soa_features_unsupported_reason,
    soa_unsupported_reason,
    substep_soa,
)
from nnx_ppo_tpu_torch.physics.model import Model
from nnx_ppo_tpu_torch.physics.randomize import FIELDS as DR_FIELDS
from nnx_ppo_tpu_torch.physics.terrain import Terrain

# One warp per block: a few thousand envs then spread over as many SMs as
# there are warps, and each warp has its SM's L1 for its per-thread arrays.
THREADS_PER_BLOCK = 32
# Without fused multiply-adds the kernel rounds every product and sum on
# its own, as the plain version does, which keeps the two within the
# stated tolerances across the contact switch (phi > 0).
KERNEL_FLAGS: tuple[str, ...] = ("-fmad=false",)


def _split_extra(extra_lanes: Sequence, dr_fields: Sequence[str], has_push: bool,
                 n_terrain_planes: int = 0) -> tuple[dict, dict]:
    """Unpack the packed per-env extras into (substep kwargs, crba
    kwargs) (``pallas_step.py::_split_extra``)."""
    sub_kw: dict = {}
    for i, name in enumerate(dr_fields):
        sub_kw[name] = extra_lanes[i]
    n = len(dr_fields)
    if has_push:
        sub_kw["push"] = tuple(extra_lanes[n + k] for k in range(3))
        n += 3
    if n_terrain_planes:
        sub_kw["terrain_planes"] = tuple(
            tuple(extra_lanes[n + 3 * g + k] for k in range(3))
            for g in range(n_terrain_planes)
        )
    crba_kw = {k: v for k, v in sub_kw.items() if k in ("mass_scale", "damping_scale")}
    return sub_kw, crba_kw


class ControlStepPlan:
    """Everything about one control-step configuration that does not
    depend on the state: the checks, the ``extra`` layout, and (built on
    first CUDA use) the kernel's library and its packed model struct."""

    def __init__(
        self,
        model: Model,
        kp: float,
        dt: float,
        n_substeps: int,
        exact: bool = False,
        *,
        terrain: Optional[Terrain] = None,
        dr_fields: Sequence[str] = (),
        has_push: bool = False,
        n_terrain_planes: int = 0,
    ):
        reason = soa_unsupported_reason(model) or soa_features_unsupported_reason(terrain=terrain)
        if reason is not None:
            raise ValueError(reason)
        unknown = [name for name in dr_fields if name not in DR_FIELDS]
        if unknown:
            raise ValueError(f"unknown domain-randomization fields {unknown}")
        if n_terrain_planes not in (0, len(model.geom_body)):
            raise ValueError("n_terrain_planes must be 0 or the number of ground geoms")
        if terrain is not None and n_terrain_planes:
            raise ValueError("terrain and terrain planes are mutually exclusive")
        self.model = model
        self.kp = float(kp)
        self.dt = float(dt)
        self.n_substeps = int(n_substeps)
        self.exact = bool(exact)
        self.terrain = terrain
        self.dr_fields = tuple(dr_fields)
        self.has_push = bool(has_push)
        self.n_terrain_planes = int(n_terrain_planes)
        self.n_extra = len(self.dr_fields) + (3 if has_push else 0) + 3 * self.n_terrain_planes
        self.n_geoms = len(model.geom_body) + len(model.pair_geom_a)

    # -- shapes ------------------------------------------------------------

    def check(self, qpos, qvel, target, extra) -> int:
        """Validate one call's arguments; returns the batch size."""
        model = self.model
        if qpos.ndim != 2 or qpos.shape[1] != model.nq:
            raise ValueError(f"qpos must be [B, {model.nq}], got {tuple(qpos.shape)}")
        B = qpos.shape[0]
        expected = {"qvel": (qvel, model.nv), "target": (target, model.nj)}
        if self.n_extra:
            if extra is None:
                raise ValueError(f"extra [B, {self.n_extra}] is required")
            expected["extra"] = (extra, self.n_extra)
        elif extra is not None:
            raise ValueError("extra was given but no per-env lanes are configured")
        for name, (x, width) in expected.items():
            if tuple(x.shape) != (B, width) or x.device != qpos.device:
                raise ValueError(
                    f"{name}: expected shape {(B, width)} on {qpos.device}, got "
                    f"{tuple(x.shape)} on {x.device}"
                )
        return B

    # -- the plain version -----------------------------------------------

    def plain(self, qpos, qvel, target, extra=None):
        self.check(qpos, qvel, target, extra)
        model, dt = self.model, self.dt
        with torch.no_grad():
            qp = tuple(qpos.to(torch.float32).unbind(1))
            qv = tuple(qvel.to(torch.float32).unbind(1))
            tgt = tuple(target.to(torch.float32).unbind(1))
            if self.n_extra:
                sub_kw, crba_kw = _split_extra(
                    extra.to(torch.float32).unbind(1), self.dr_fields, self.has_push,
                    self.n_terrain_planes,
                )
            else:
                sub_kw, crba_kw = {}, {}
            chol = None if self.exact else crba_chol_soa(model, qp, dt, **crba_kw)
            normals: tuple = ()
            for _ in range(self.n_substeps):
                if self.exact:
                    chol = crba_chol_soa(model, qp, dt, **crba_kw)
                qp, qv, normals = substep_soa(
                    model, qp, qv, tgt, chol, self.kp, dt, terrain=self.terrain, **sub_kw
                )
            normals_out = (
                torch.stack(normals, dim=1) if normals else qpos.new_zeros((qpos.shape[0], 0))
            )
            return torch.stack(qp, dim=1), torch.stack(qv, dim=1), normals_out

    # -- the kernel --------------------------------------------------------

    @property
    def sizes(self) -> dict[str, int]:
        """The ``-D`` defines that size the kernel's arrays."""
        return {
            "CS_NB": self.model.n_bodies,
            "CS_NG": len(self.model.geom_body),
            "CS_NP": len(self.model.pair_geom_a),
            "CS_NW": 0 if self.terrain is None else len(self.terrain.amplitudes),
        }

    @property
    def kernel_spec(self) -> tuple[str, tuple[str, ...]]:
        """What ``cuda_build.build`` takes to build this plan's library."""
        return "control_step", cuda_build.define_flags(self.sizes) + KERNEL_FLAGS

    @functools.cached_property
    def _packed(self):
        """(C entry point, packed model struct), built on first use."""
        params = pack_params(self)
        lib = cuda_build.load(*self.kernel_spec)
        built_for = (ctypes.c_int * 4)()
        lib.control_step_params_size.argtypes = [ctypes.c_void_p]
        lib.control_step_params_size.restype = ctypes.c_int
        size = lib.control_step_params_size(built_for)
        want = [self.sizes[k] for k in ("CS_NB", "CS_NG", "CS_NP", "CS_NW")]
        if size != ctypes.sizeof(params) or list(built_for) != want:
            raise RuntimeError(
                f"control_step library was built for sizes {list(built_for)} "
                f"(struct of {size} bytes); this plan needs {want} "
                f"({ctypes.sizeof(params)} bytes)"
            )
        fn = lib.control_step_forward
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p] + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        return fn, params

    def cuda(self, qpos, qvel, target, extra=None):
        B = self.check(qpos, qvel, target, extra)
        device = qpos.device
        if device.type != "cuda":
            raise ValueError(f"control_step_cuda takes CUDA tensors, got {device}")
        if B >= 2**31 // max(self.model.nq, self.n_extra, 1):
            raise ValueError(f"B = {B} is too large for the kernel")
        model = self.model
        qpos_out = torch.empty((B, model.nq), dtype=torch.float32, device=device)
        qvel_out = torch.empty((B, model.nv), dtype=torch.float32, device=device)
        normals_out = torch.empty((B, self.n_geoms), dtype=torch.float32, device=device)
        if B == 0:
            return qpos_out, qvel_out, normals_out
        with torch.no_grad():
            ins = [x.detach().to(torch.float32).contiguous() for x in (qpos, qvel, target)]
            extra_in = None if extra is None else extra.detach().to(torch.float32).contiguous()
        fn, params = self._packed
        stream = torch.cuda.current_stream(device)
        err = fn(
            *(x.data_ptr() for x in ins),
            None if extra_in is None else extra_in.data_ptr(),
            qpos_out.data_ptr(), qvel_out.data_ptr(), normals_out.data_ptr(),
            B, ctypes.addressof(params), THREADS_PER_BLOCK,
            stream.device.index, stream.cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"control_step kernel launch failed: cudaError_t {err}")
        control_step_cuda.launches += 1
        return qpos_out, qvel_out, normals_out

    def __call__(self, qpos, qvel, target, extra=None):
        """Dispatch by device: the kernel for CUDA tensors, the plain
        version for CPU tensors; any other device raises."""
        device = qpos.device
        if device.type == "cuda":
            return self.cuda(qpos, qvel, target, extra)
        if device.type == "cpu":
            return self.plain(qpos, qvel, target, extra)
        raise ValueError(f"the control step has no implementation for device {device}")


def _spatial_inertia_blocks(model: Model, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Body ``i``'s spatial inertia about its origin as 3x3 blocks
    (ang-ang, ang-lin, lin-lin), in float64 as the plain version folds
    its constants."""
    m = float(model.mass[i])
    c = np.asarray(model.com[i], np.float64)
    cx = np.array([[0.0, -c[2], c[1]], [c[2], 0.0, -c[0]], [-c[1], c[0], 0.0]])
    inertia = np.asarray(model.inertia[i], np.float64)
    return inertia + m * cx @ cx.T, m * cx, m * np.eye(3)


def pack_params(plan: ControlStepPlan) -> ctypes.Structure:
    """The kernel's model struct (``struct Params`` of
    ``csrc/control_step.cu``: same members, same order, all 4 bytes
    wide), filled from the plan."""
    model, terrain = plan.model, plan.terrain
    nb, nv, nj = model.n_bodies, model.nv, model.nj
    ng, npairs = len(model.geom_body), len(model.pair_geom_a)
    nw = plan.sizes["CS_NW"]
    f32, i32 = ctypes.c_float, ctypes.c_int

    def at_least_1(n: int) -> int:
        return max(n, 1)

    def padded(values, n: int, dtype=np.float64) -> np.ndarray:
        out = np.zeros((at_least_1(n),) + np.shape(values)[1:], dtype)
        out[:n] = values
        return out

    blocks = [_spatial_inertia_blocks(model, i) for i in range(nb)]
    has_limits = model.joint_lower.size > 0
    has_springs = model.spring_stiffness.size > 0
    damping = np.asarray(model.damping, np.float64)
    waves = terrain if terrain is not None else Terrain()
    directions = np.asarray(waves.directions, np.float64).reshape(nw, 2)
    # Columns of `extra`, in the order the envs pack them.
    columns = {name: -1 for name in DR_FIELDS}
    for i, name in enumerate(plan.dr_fields):
        columns[name] = i
    cursor = len(plan.dr_fields)
    idx_push = cursor if plan.has_push else -1
    cursor += 3 if plan.has_push else 0
    idx_planes = cursor if plan.n_terrain_planes else -1

    members = [
        ("parent", i32, np.asarray(model.parent)),
        ("joint_axis", f32, model.joint_axis),
        ("joint_pos", f32, model.joint_pos),
        ("mass", f32, model.mass),
        ("com", f32, model.com),
        ("inertia", f32, model.inertia),
        ("blk_a", f32, np.stack([b[0] for b in blocks])),
        ("blk_b", f32, np.stack([b[1] for b in blocks])),
        ("blk_c", f32, np.stack([b[2] for b in blocks])),
        ("damping", f32, damping),
        ("dt_damping", f32, plan.dt * damping),
        ("armature", f32, model.armature),
        ("lower", f32, model.joint_lower[6:] if has_limits else np.full(nj, -np.inf)),
        ("upper", f32, model.joint_upper[6:] if has_limits else np.full(nj, np.inf)),
        ("spring_k", f32, model.spring_stiffness[6:] if has_springs else np.zeros(nj)),
        ("spring_ref", f32, model.spring_ref[6:] if has_springs else np.zeros(nj)),
        ("geom_body", i32, padded(np.asarray(model.geom_body, np.int64), ng, np.int64)),
        ("geom_offset", f32, padded(model.geom_offset, ng).reshape(at_least_1(ng), 3)),
        ("geom_radius", f32, padded(model.geom_radius, ng)),
        ("pair_a", i32, padded(np.asarray(model.pair_geom_a, np.int64), npairs, np.int64)),
        ("pair_b", i32, padded(np.asarray(model.pair_geom_b, np.int64), npairs, np.int64)),
        ("wave_amp", f32, padded(np.asarray(waves.amplitudes), nw)),
        ("wave_freq", f32, padded(np.asarray(waves.frequencies), nw)),
        ("wave_amp_freq", f32,
         padded(np.asarray(waves.amplitudes) * np.asarray(waves.frequencies), nw)),
        ("wave_dx", f32, padded(directions[:, 0], nw)),
        ("wave_dy", f32, padded(directions[:, 1], nw)),
        ("wave_phase", f32, padded(np.asarray(waves.phases), nw)),
        ("slope", f32, np.asarray(waves.slope)),
        ("gravity_up", f32, -float(model.gravity)),
        ("kp", f32, plan.kp),
        ("dt", f32, plan.dt),
        ("contact_stiffness", f32, model.contact_stiffness),
        ("contact_damping", f32, model.contact_damping),
        ("friction", f32, model.friction),
        ("friction_vel", f32, model.friction_vel),
        ("max_contact_force", f32, model.max_contact_force),
        ("limit_stiffness", f32, model.limit_stiffness),
        ("limit_damping", f32, model.limit_damping),
        ("n_substeps", i32, plan.n_substeps),
        ("exact", i32, int(plan.exact)),
        ("terrain_mode", i32, 2 if plan.n_terrain_planes else (0 if terrain is None else 1)),
        ("has_limits", i32, int(has_limits)),
        ("has_springs", i32, int(has_springs)),
        ("idx_mass_scale", i32, columns["mass_scale"]),
        ("idx_friction", i32, columns["friction"]),
        ("idx_damping_scale", i32, columns["damping_scale"]),
        ("idx_gain_scale", i32, columns["gain_scale"]),
        ("idx_push", i32, idx_push),
        ("idx_planes", i32, idx_planes),
        ("n_extra", i32, plan.n_extra),
    ]
    expected_counts = {
        "parent": nb, "joint_axis": 3 * nb, "inertia": 9 * nb, "damping": nv,
        "lower": nj, "geom_offset": 3 * at_least_1(ng), "wave_amp": at_least_1(nw),
    }
    fields, values = [], {}
    for name, ctype, value in members:
        flat = np.asarray(value).reshape(-1)
        if name in expected_counts and flat.size != expected_counts[name]:
            raise ValueError(f"{name}: {flat.size} values, expected {expected_counts[name]}")
        scalar = np.ndim(value) == 0
        fields.append((name, ctype if scalar else ctype * flat.size))
        values[name] = (scalar, ctype, flat)

    class Params(ctypes.Structure):
        _fields_ = fields

    params = Params()
    for name, (scalar, ctype, flat) in values.items():
        cast = int if ctype is i32 else float
        if scalar:
            setattr(params, name, cast(flat[0]))
        else:
            setattr(params, name, (ctype * flat.size)(*(cast(x) for x in flat)))
    return params


def control_step_plain(model: Model, qpos, qvel, target, kp: float, dt: float,
                       n_substeps: int, *, exact: bool = False, terrain=None, extra=None,
                       dr_fields: Sequence[str] = (), has_push: bool = False,
                       n_terrain_planes: int = 0):
    """The plain PyTorch version of one control step: ``(qpos[B, nq],
    qvel[B, nv], target[B, nj][, extra[B, n_extra]]) -> (qpos', qvel',
    normals[B, n_geoms])``, float32, no gradient."""
    plan = ControlStepPlan(model, kp, dt, n_substeps, exact, terrain=terrain,
                           dr_fields=dr_fields, has_push=has_push,
                           n_terrain_planes=n_terrain_planes)
    return plan.plain(qpos, qvel, target, extra)


def control_step_cuda(model: Model, qpos, qvel, target, kp: float, dt: float,
                      n_substeps: int, *, exact: bool = False, terrain=None, extra=None,
                      dr_fields: Sequence[str] = (), has_push: bool = False,
                      n_terrain_planes: int = 0):
    """One control step through the CUDA kernel, on the current stream
    (same signature as :func:`control_step_plain`). A caller that steps
    repeatedly keeps a :class:`ControlStepPlan` (or a runner) instead, so
    that the model struct is packed once."""
    plan = ControlStepPlan(model, kp, dt, n_substeps, exact, terrain=terrain,
                           dr_fields=dr_fields, has_push=has_push,
                           n_terrain_planes=n_terrain_planes)
    return plan.cuda(qpos, qvel, target, extra)


# Counted in ControlStepPlan.cuda, where the kernel launches.
control_step_cuda.launches = 0


def make_control_step_runner(
    model: Model,
    kp: float,
    dt: float,
    n_substeps: int,
    exact: bool = False,
    *,
    terrain: Optional[Terrain] = None,
    dr_fields: Sequence[str] = (),
    has_push: bool = False,
) -> ControlStepPlan:
    """``run(qpos[B, nq], qvel[B, nv], target[B, nj][, extra[B, n_extra]])
    -> (qpos', qvel', normals[B, n_geoms])`` for one env configuration:
    one kernel launch per control step on CUDA tensors, the plain version
    on CPU tensors. ``exact`` rebuilds the factor at every substep (exact
    dynamics instead of the held-factor approximation). ``extra`` is
    ``[len(dr_fields) + 3·has_push]`` wide; when both are off the runner
    takes three arguments. The runner is the (callable) plan."""
    return ControlStepPlan(model, kp, dt, n_substeps, exact, terrain=terrain,
                           dr_fields=dr_fields, has_push=has_push)
