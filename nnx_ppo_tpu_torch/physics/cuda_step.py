"""The legged-robot physics step: three CUDA kernels, their plain
PyTorch versions, and the runners the envs call.

Port of ``nnx_ppo_tpu/physics/pallas_step.py:36-711`` (``pallas_substeps``,
``pallas_plane_sampler``, ``pallas_control_step``,
``make_control_step_runner``, ``make_substep_runner``). A control step is
the Cholesky factor of ``M + armature + dt·D`` built from the pre-substep
``qpos`` (held over the step, or rebuilt at every substep with
``exact``), then ``n_substeps`` SoA substeps; it returns the integrated
``qpos``/``qvel`` and the contact normal forces of the last substep
(ground geoms first, then pairs).

* :func:`control_step_plain` is the plain PyTorch version: the lane
  functions of ``engine_soa.py`` over the columns of the ``[B, k]``
  inputs. :func:`control_step_cuda` launches the hand-written kernel of
  ``nnx_ppo_tpu_torch/csrc/control_step.cu`` once per control step and
  counts its launches in ``control_step_cuda.launches``.
* :func:`plane_sampler_plain` / :func:`plane_sampler_cuda`
  (``.launches``, ``csrc/plane_sampler.cu``): kinematics, then per ground
  geom the tangent plane ``(c, gx, gy)`` of a ``HeightGrid`` at its world
  xy, ``[B, 3·n_geoms]``.
* :func:`substeps_plain` / :func:`substeps_cuda` (``.launches``, the
  second entry point of ``csrc/control_step.cu``): substeps with the
  factor built outside and passed in as ``chol[B, nv, nv]``; flat ground,
  no per-env lanes.
* :func:`make_control_step_runner` returns ``run(qpos, qvel, target[,
  extra])`` and :func:`make_substep_runner` ``run(qpos, qvel, target,
  chol)``. Both dispatch by the tensors' device as ``ops/gae.py`` does:
  the kernels for CUDA tensors, the plain versions for CPU tensors.
  There is no fallback: a CUDA tensor that a kernel cannot take, a
  failed build or a failed launch raises.

``extra`` packs the per-env lanes ``[B, n_extra]``: the
domain-randomization scalars named by ``dr_fields`` (in that order),
then the 3 push-force lanes (``has_push``), then ``n_terrain_planes``
tangent-plane triples ``(c, gx, gy)``. With ``terrain=HeightGrid`` the
runner samples the planes itself at control-step start (one sampler
launch, then one control-step launch) and appends them after the
caller's lanes, so the caller's ``extra`` stays ``[len(dr_fields) +
3·has_push]`` wide. The JAX runner's ``custom_vmap``,
``custom_partitioning`` and tile picking have no counterpart: the batch
dimension is written out and the kernels mask the ragged edge.

The kernels' array sizes (bodies, geoms, pairs, terrain waves) and each
kernel's lanes per env (``CS_G`` of the control step, ``PS_G`` of the plane
sampler) are ``-D`` defines, so each model size is one library per source;
everything else about the model (topology, inertias,
geoms, gains, terrain waves, feature switches, and the schedules the lane
groups walk: :func:`tree_schedule`, :func:`contact_schedule`) is a struct
filled here from the ``Model`` and passed to the kernels by value (to the
plane sampler as a copy uploaded once per device).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from nnx_ppo_tpu_torch.ops import cuda_build
from nnx_ppo_tpu_torch.physics.engine_soa import (
    _kin_soa,
    crba_chol_soa,
    heightgrid_planes_soa,
    soa_features_unsupported_reason,
    soa_unsupported_reason,
    substep_soa,
)
from nnx_ppo_tpu_torch.physics.model import Model
from nnx_ppo_tpu_torch.physics.randomize import FIELDS as DR_FIELDS
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid, Terrain

# The -D defines, in the order the libraries' *_params_size report them:
# the model sizes, then the lanes per env of the library's kernel.
SIZE_NAMES = ("CS_NB", "CS_NG", "CS_NP", "CS_NW", "CS_G")
SAMPLER_SIZE_NAMES = SIZE_NAMES[:4] + ("PS_G",)

# Lanes per env (a -D size that divides 32) and threads per block (a
# multiple of 32) of the control-step and substeps kernels: the fastest
# pair of the sweep of ``chip_smoke.py --variants`` on the H100 (PERF.md).
CONTROL_STEP_GROUP = 16
CONTROL_STEP_THREADS = 128
# Lanes per env (one per ground geom of the quadruped) and threads per
# block of the plane sampler: the fastest of the sweep of ``chip_smoke.py``
# on the H100 (PERF.md).
PLANE_SAMPLER_GROUP = 8
PLANE_SAMPLER_THREADS = 64
# Without fused multiply-adds the kernels round every product and sum on
# their own, as the plain versions do, which keeps the two within the
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


def tree_schedule(parent: Sequence[int]) -> dict:
    """The order in which a kernel's lane group walks a forest whose bodies
    come after their parents (``parent[i] < i``, -1 at a root):
    ``level_body[level_start[l]:level_start[l + 1]]`` are the bodies of
    depth ``l`` in index order (roots first), and
    ``child_list[child_start[i]:child_start[i + 1]]`` body ``i``'s children
    in descending index order, the order in which the plain versions'
    leaves-to-root loops add them into it."""
    nb = len(parent)
    depth: list[int] = []
    for i, p in enumerate(parent):
        if p >= i:
            raise ValueError(f"body {i} comes before its parent {p}")
        depth.append(0 if p < 0 else depth[p] + 1)
    n_levels = max(depth) + 1 if nb else 0
    children = [[c for c in reversed(range(nb)) if parent[c] == i] for i in range(nb)]
    return {
        "n_levels": n_levels,
        "level_start": [sum(d < l for d in depth) for l in range(n_levels + 1)],
        "level_body": sorted(range(nb), key=lambda i: (depth[i], i)),
        "child_start": [int(x) for x in np.cumsum([0] + [len(c) for c in children])],
        "child_list": [c for cs in children for c in cs],
    }


def contact_schedule(n_bodies: int, geom_body: Sequence[int], pair_body_a: Sequence[int],
                     pair_body_b: Sequence[int]) -> dict:
    """Which contact wrenches each body takes, in the order the plain
    versions subtract them: its ground geoms in order (slot ``g``), then
    each pair ``k`` that touches it, the force on the pair's b body (slot
    ``n_geoms + 2k``) before the one on its a body (``n_geoms + 2k + 1``).
    Body ``i``'s slots are ``contact_slot[contact_start[i]:contact_start[i
    + 1]]``."""
    ng = len(geom_body)
    slots: list[list[int]] = [[] for _ in range(n_bodies)]
    for g, b in enumerate(geom_body):
        slots[int(b)].append(g)
    for k, (ba, bb) in enumerate(zip(pair_body_a, pair_body_b)):
        slots[int(bb)].append(ng + 2 * k)
        slots[int(ba)].append(ng + 2 * k + 1)
    return {
        "contact_start": [int(x) for x in np.cumsum([0] + [len(x) for x in slots])],
        "contact_slot": [x for xs in slots for x in xs],
    }


def padded_schedule(schedule: dict, lengths: dict) -> dict:
    """Each list of ``schedule`` padded to its struct length (``lengths``)
    with its last entry (or 0): a padded ``*_start`` entry marks an empty
    range."""
    out = {}
    for name, values in schedule.items():
        if name not in lengths:
            out[name] = values
            continue
        n = lengths[name]
        if len(values) > n:
            raise ValueError(f"{name}: {len(values)} entries for {n}")
        out[name] = list(values) + [values[-1] if values else 0] * (n - len(values))
    return out


def _tri_indices(nv: int) -> list[tuple[int, int]]:
    """Row-major lower-triangle index pairs: entry ``i (i + 1) / 2 + j`` of
    the packed factor is ``chol[i, j]`` (``pallas_step.py::_tri_indices``)."""
    return [(i, j) for i in range(nv) for j in range(i + 1)]


class ControlStepPlan:
    """Everything about one physics-step configuration that does not
    depend on the state: the checks, the ``extra`` layout, and (built on
    first CUDA use) the kernels' libraries and the packed model struct
    they share."""

    def __init__(
        self,
        model: Model,
        kp: float,
        dt: float,
        n_substeps: int,
        exact: bool = False,
        *,
        terrain: Union[Terrain, HeightGrid, None] = None,
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
        # A HeightGrid never enters the substep: its planes do, sampled
        # by this plan at control-step start.
        self.heightgrid = terrain if isinstance(terrain, HeightGrid) else None
        self.terrain = None if self.heightgrid is not None else terrain
        self.dr_fields = tuple(dr_fields)
        self.has_push = bool(has_push)
        self.n_terrain_planes = (
            len(model.geom_body) if self.heightgrid is not None else int(n_terrain_planes)
        )
        # Width of the kernel's `extra`, and of the part the caller hands in.
        self.n_extra = len(self.dr_fields) + (3 if has_push else 0) + 3 * self.n_terrain_planes
        self.n_caller_extra = self.n_extra - (
            3 * self.n_terrain_planes if self.heightgrid is not None else 0
        )
        self.n_geoms = len(model.geom_body) + len(model.pair_geom_a)
        # The kernels' launches: lanes per env and threads per block of the
        # control-step and substeps kernels, and of the plane sampler (set
        # before the first CUDA call to try others).
        self.group_size = CONTROL_STEP_GROUP
        self.threads_per_block = CONTROL_STEP_THREADS
        self.sampler_group = PLANE_SAMPLER_GROUP
        self.sampler_threads = PLANE_SAMPLER_THREADS
        self._sampler_launches: dict = {}

    # -- shapes ------------------------------------------------------------

    def check(self, qpos, qvel, target, extra) -> int:
        """Validate one call's arguments (``extra`` as the caller hands it
        in); returns the batch size."""
        model = self.model
        if qpos.ndim != 2 or qpos.shape[1] != model.nq:
            raise ValueError(f"qpos must be [B, {model.nq}], got {tuple(qpos.shape)}")
        B = qpos.shape[0]
        expected = {"qvel": (qvel, model.nv), "target": (target, model.nj)}
        if self.n_caller_extra:
            if extra is None:
                raise ValueError(f"extra [B, {self.n_caller_extra}] is required")
            expected["extra"] = (extra, self.n_caller_extra)
        elif extra is not None:
            raise ValueError("extra was given but no per-env lanes are configured")
        for name, (x, width) in expected.items():
            if tuple(x.shape) != (B, width) or x.device != qpos.device:
                raise ValueError(
                    f"{name}: expected shape {(B, width)} on {qpos.device}, got "
                    f"{tuple(x.shape)} on {x.device}"
                )
        return B

    def _with_planes(self, extra, planes):
        """The kernel's ``extra``: the caller's lanes, then the sampled
        planes (HeightGrid terrain only)."""
        if self.heightgrid is None:
            return extra
        return planes if extra is None else torch.cat([extra.to(torch.float32), planes], dim=1)

    # -- the plain versions ------------------------------------------------

    def sample_planes_plain(self, qpos):
        """``[B, 3·n_geoms]`` tangent planes of the HeightGrid under the
        ground geoms, by the lane functions."""
        if self.heightgrid is None:
            raise ValueError("this plan has no HeightGrid terrain to sample")
        with torch.no_grad():
            qp = tuple(qpos.to(torch.float32).unbind(1))
            E, P, _, _, _ = _kin_soa(self.model, qp)
            planes = heightgrid_planes_soa(self.heightgrid, self.model, E, P)
            return torch.stack([lane for plane in planes for lane in plane], dim=1)

    def plain(self, qpos, qvel, target, extra=None):
        self.check(qpos, qvel, target, extra)
        if self.heightgrid is not None:
            extra = self._with_planes(extra, self.sample_planes_plain(qpos))
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
            return self._stacked(qpos, qp, qv, normals)

    @staticmethod
    def _stacked(qpos, qp, qv, normals):
        normals_out = (
            torch.stack(normals, dim=1) if normals else qpos.new_zeros((qpos.shape[0], 0))
        )
        return torch.stack(qp, dim=1), torch.stack(qv, dim=1), normals_out

    def substeps_plain(self, qpos, qvel, target, chol, n_launches: int = 1):
        """``n_launches`` × ``n_substeps`` substeps with the factor
        ``chol[B, nv, nv]`` handed in (flat ground, no per-env lanes)."""
        self._check_substeps(qpos, qvel, target, chol)
        with torch.no_grad():
            qp = tuple(qpos.to(torch.float32).unbind(1))
            qv = tuple(qvel.to(torch.float32).unbind(1))
            tgt = tuple(target.to(torch.float32).unbind(1))
            chol = chol.to(torch.float32)
            lanes = tuple(
                tuple(chol[:, i, j] for j in range(i + 1)) for i in range(self.model.nv)
            )
            normals: tuple = ()
            for _ in range(n_launches * self.n_substeps):
                qp, qv, normals = substep_soa(self.model, qp, qv, tgt, lanes, self.kp, self.dt)
            return self._stacked(qpos, qp, qv, normals)

    def _check_substeps(self, qpos, qvel, target, chol) -> int:
        if self.n_extra or self.terrain is not None or self.exact:
            raise ValueError(
                "the substeps kernel takes flat ground, no per-env lanes and a held factor"
            )
        B = self.check(qpos, qvel, target, None)
        nv = self.model.nv
        if tuple(chol.shape) != (B, nv, nv) or chol.device != qpos.device:
            raise ValueError(
                f"chol: expected shape {(B, nv, nv)} on {qpos.device}, got "
                f"{tuple(chol.shape)} on {chol.device}"
            )
        return B

    # -- the kernels -------------------------------------------------------

    @property
    def sizes(self) -> dict[str, int]:
        """The ``-D`` defines that size the kernels' arrays, and the
        control step's lanes per env."""
        return {
            "CS_NB": self.model.n_bodies,
            "CS_NG": len(self.model.geom_body),
            "CS_NP": len(self.model.pair_geom_a),
            "CS_NW": 0 if self.terrain is None else len(self.terrain.amplitudes),
            "CS_G": self.group_size,
        }

    @property
    def sampler_sizes(self) -> dict[str, int]:
        """The plane sampler's ``-D`` defines: the model sizes and its own
        lanes per env (the control step's do not enter its library)."""
        sizes = {k: v for k, v in self.sizes.items() if k != "CS_G"}
        return dict(sizes, PS_G=self.sampler_group)

    def _spec(self, name: str) -> tuple[str, tuple[str, ...]]:
        sizes = self.sampler_sizes if name == "plane_sampler" else self.sizes
        return name, cuda_build.define_flags(sizes) + KERNEL_FLAGS

    @property
    def kernel_spec(self) -> tuple[str, tuple[str, ...]]:
        """What ``cuda_build.build`` takes to build the control-step and
        substeps library of this plan."""
        return self._spec("control_step")

    @property
    def kernel_specs(self) -> list[tuple[str, tuple[str, ...]]]:
        """Every library this plan's kernels come from."""
        specs = [self.kernel_spec]
        if self.heightgrid is not None:
            specs.append(self.sampler_spec)
        return specs

    @property
    def sampler_spec(self) -> tuple[str, tuple[str, ...]]:
        """What ``cuda_build.build`` takes to build this plan's plane
        sampler."""
        return self._spec("plane_sampler")

    @functools.cached_property
    def _params(self) -> ctypes.Structure:
        return pack_params(self)

    def _library(self, name: str) -> ctypes.CDLL:
        """The library of source ``name``, checked against this plan's
        struct: a library built for other sizes must not be launched."""
        lib = cuda_build.load(*self._spec(name))
        built_for = (ctypes.c_int * len(SIZE_NAMES))()
        size_fn = getattr(lib, f"{name}_params_size")
        size_fn.argtypes = [ctypes.c_void_p]
        size_fn.restype = ctypes.c_int
        size = size_fn(built_for)
        if name == "plane_sampler":
            want = [self.sampler_sizes[k] for k in SAMPLER_SIZE_NAMES]
        else:
            want = [self.sizes[k] for k in SIZE_NAMES]
        if size != ctypes.sizeof(self._params) or list(built_for) != want:
            raise RuntimeError(
                f"{name} library was built for sizes {list(built_for)} "
                f"(struct of {size} bytes); this plan needs {want} "
                f"({ctypes.sizeof(self._params)} bytes)"
            )
        return lib

    @functools.cached_property
    def _step_entry_points(self) -> dict:
        """``control_step_forward`` and ``substeps_forward``: the same
        signature, the fourth pointer being ``extra`` or the packed
        factor."""
        lib = self._library("control_step")
        fns = {}
        for name in ("control_step_forward", "substeps_forward"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p] + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            fns[name] = fn
        smem = lib.control_step_smem_bytes
        smem.argtypes = [ctypes.c_int]
        smem.restype = ctypes.c_longlong
        fns["control_step_smem_bytes"] = smem
        return fns

    def shared_memory_bytes(self) -> int:
        """Dynamic shared memory of one block of the control-step and
        substeps kernels at this plan's launch (the model struct and
        ``threads_per_block / group_size`` envs), from the library."""
        return int(self._step_entry_points["control_step_smem_bytes"](self.threads_per_block))

    @functools.cached_property
    def _sampler_entry_points(self) -> dict:
        lib = self._library("plane_sampler")
        fn = lib.plane_sampler_forward
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        smem = lib.plane_sampler_smem_bytes
        smem.argtypes = [ctypes.c_int]
        smem.restype = ctypes.c_longlong
        return {"forward": fn, "smem_bytes": smem}

    def sampler_shared_memory_bytes(self) -> int:
        """Dynamic shared memory of one block of the plane sampler at this
        plan's launch, from the library."""
        return int(self._sampler_entry_points["smem_bytes"](self.sampler_threads))

    def _sampler_launch(self, device: torch.device) -> tuple:
        """The sampler's entry point and every argument of its launch that
        does not change from call to call, built once per device: the table
        and the struct, uploaded (padded with zeros to a multiple of 16
        bytes, as the kernel copies it in 16-byte pieces) and kept alive
        here, and the grid constants."""
        launch = self._sampler_launches.get(device)
        if launch is None:
            grid = self.heightgrid
            table = grid.table(device)
            nx, ny = grid.shape
            raw = bytes(self._params)
            model = torch.frombuffer(bytearray(raw + bytes(-len(raw) % 16)),
                                     dtype=torch.uint8).to(device)
            launch = (
                self._sampler_entry_points["forward"], (table, model),
                ctypes.c_void_p(table.data_ptr()),
                (ctypes.c_int(nx), ctypes.c_int(ny), ctypes.c_float(grid.x0),
                 ctypes.c_float(grid.y0), ctypes.c_float(1.0 / grid.dx),
                 ctypes.c_float(1.0 / grid.dy), ctypes.c_void_p(model.data_ptr()),
                 ctypes.c_int(self.sampler_threads), ctypes.c_int(device.index)),
            )
            self._sampler_launches[device] = launch
        return launch

    def _cuda_batch(self, qpos, B: int) -> torch.device:
        device = qpos.device
        if device.type != "cuda":
            raise ValueError(f"the kernels take CUDA tensors, got {device}")
        widest = max(self.model.nv * (self.model.nv + 1) // 2, self.n_extra, self.group_size, 1)
        if B >= 2**31 // widest:
            raise ValueError(f"B = {B} is too large for the kernels")
        return device

    def _launch_step(self, entry: str, qpos, qvel, target, fourth, B: int):
        """Allocate the outputs and launch ``entry`` on the current
        stream; ``fourth`` is ``extra`` (or None) or the packed factor."""
        device = qpos.device
        model = self.model
        qpos_out = torch.empty((B, model.nq), dtype=torch.float32, device=device)
        qvel_out = torch.empty((B, model.nv), dtype=torch.float32, device=device)
        normals_out = torch.empty((B, self.n_geoms), dtype=torch.float32, device=device)
        if B == 0:
            return qpos_out, qvel_out, normals_out
        with torch.no_grad():
            ins = [x.detach().to(torch.float32).contiguous() for x in (qpos, qvel, target)]
            fourth_in = None if fourth is None else fourth.detach().to(torch.float32).contiguous()
        stream = torch.cuda.current_stream(device)
        err = self._step_entry_points[entry](
            *(x.data_ptr() for x in ins),
            None if fourth_in is None else fourth_in.data_ptr(),
            qpos_out.data_ptr(), qvel_out.data_ptr(), normals_out.data_ptr(),
            B, ctypes.addressof(self._params), self.threads_per_block,
            stream.device.index, stream.cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"{entry} kernel launch failed: cudaError_t {err}")
        return qpos_out, qvel_out, normals_out

    def sample_planes_cuda(self, qpos):
        """``[B, 3·n_geoms]`` tangent planes of the HeightGrid under the
        ground geoms, by one launch of the plane-sampler kernel. ``qpos`` is
        used in place when it is float32 and contiguous, else copied."""
        if self.heightgrid is None:
            raise ValueError("this plan has no HeightGrid terrain to sample")
        model = self.model
        if qpos.ndim != 2 or qpos.shape[1] != model.nq:
            raise ValueError(f"qpos must be [B, {model.nq}], got {tuple(qpos.shape)}")
        B = qpos.shape[0]
        device = self._cuda_batch(qpos, B)
        planes = torch.empty((B, 3 * len(model.geom_body)), dtype=torch.float32, device=device)
        if B == 0:
            return planes
        if qpos.dtype != torch.float32 or not qpos.is_contiguous():
            qpos = qpos.to(torch.float32).contiguous()
        forward, _, table, fixed = self._sampler_launch(device)
        stream = torch.cuda.current_stream(device)
        err = forward(qpos.data_ptr(), table, planes.data_ptr(), B, *fixed, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"plane_sampler kernel launch failed: cudaError_t {err}")
        plane_sampler_cuda.launches += 1
        return planes

    def cuda(self, qpos, qvel, target, extra=None):
        B = self.check(qpos, qvel, target, extra)
        self._cuda_batch(qpos, B)
        if self.heightgrid is not None:
            extra = self._with_planes(extra, self.sample_planes_cuda(qpos))
        out = self._launch_step("control_step_forward", qpos, qvel, target, extra, B)
        if B:
            control_step_cuda.launches += 1
        return out

    def substeps_cuda(self, qpos, qvel, target, chol, n_launches: int = 1):
        """``n_launches`` launches of the substeps kernel, each
        ``n_substeps`` substeps, with the factor ``chol[B, nv, nv]`` handed
        in (packed once)."""
        B = self._check_substeps(qpos, qvel, target, chol)
        self._cuda_batch(qpos, B)
        packed = pack_factor(chol.detach().to(torch.float32))
        normals = None
        for _ in range(n_launches):
            qpos, qvel, normals = self._launch_step(
                "substeps_forward", qpos, qvel, target, packed, B
            )
            if B:
                substeps_cuda.launches += 1
        return qpos, qvel, normals

    def __call__(self, qpos, qvel, target, extra=None):
        """Dispatch by device: the kernels for CUDA tensors, the plain
        versions for CPU tensors; any other device raises."""
        device = qpos.device
        if device.type == "cuda":
            return self.cuda(qpos, qvel, target, extra)
        if device.type == "cpu":
            return self.plain(qpos, qvel, target, extra)
        raise ValueError(f"the control step has no implementation for device {device}")


@functools.lru_cache(maxsize=None)
def _tri_columns(nv: int, device: torch.device) -> torch.Tensor:
    """Columns of the flattened ``[nv·nv]`` matrix in packed order."""
    return torch.tensor([i * nv + j for i, j in _tri_indices(nv)], device=device)


def pack_factor(chol: torch.Tensor) -> torch.Tensor:
    """``chol[B, nv, nv]`` -> the packed lower triangle ``[B, nv (nv + 1)
    / 2]`` in the order of :func:`_tri_indices`, as the substeps kernel
    reads it."""
    nv = chol.shape[-1]
    flat = chol.reshape(chol.shape[0], nv * nv)
    return flat.index_select(1, _tri_columns(nv, chol.device))


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
    schedule = padded_schedule(
        {
            **tree_schedule(model.parent),
            **contact_schedule(
                nb, model.geom_body, [model.geom_body[g] for g in model.pair_geom_a],
                [model.geom_body[g] for g in model.pair_geom_b],
            ),
        },
        {"level_start": nb + 1, "level_body": nb, "child_start": nb + 1, "child_list": nb,
         "contact_start": nb + 1, "contact_slot": at_least_1(ng + 2 * npairs)},
    )
    for name in ("level_start", "level_body", "child_start", "child_list", "contact_start",
                 "contact_slot", "n_levels"):
        members.append((name, i32, np.asarray(schedule[name], np.int64)))
    expected_counts = {
        "parent": nb, "joint_axis": 3 * nb, "inertia": 9 * nb, "damping": nv,
        "lower": nj, "geom_offset": 3 * at_least_1(ng), "wave_amp": at_least_1(nw),
        "level_start": nb + 1, "child_list": nb, "contact_slot": at_least_1(ng + 2 * npairs),
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


def _sampler_plan(model: Model, grid: HeightGrid) -> ControlStepPlan:
    # The sampler reads the tree and the geoms of the shared struct; the
    # gains and the step length in it are not its concern.
    return ControlStepPlan(model, 0.0, 0.0, 0, terrain=grid)


def plane_sampler_plain(model: Model, grid: HeightGrid, qpos):
    """The plain PyTorch version of the plane sampler: ``qpos[B, nq] ->
    planes[B, 3·n_geoms]``, ``(c, gx, gy)`` per ground geom, float32."""
    return _sampler_plan(model, grid).sample_planes_plain(qpos)


def plane_sampler_cuda(model: Model, grid: HeightGrid, qpos):
    """The plane sampler through its CUDA kernel, on the current stream
    (same signature as :func:`plane_sampler_plain`)."""
    return _sampler_plan(model, grid).sample_planes_cuda(qpos)


def substeps_plain(model: Model, qpos, qvel, target, chol, kp: float, dt: float,
                   n_substeps: int):
    """The plain PyTorch version of the substeps kernel: ``n_substeps``
    substeps with the factor ``chol[B, nv, nv]`` of ``M + dt·D`` handed
    in; flat ground, no per-env lanes. Returns ``(qpos', qvel',
    normals[B, n_geoms])`` of the last substep."""
    return ControlStepPlan(model, kp, dt, n_substeps).substeps_plain(qpos, qvel, target, chol)


def substeps_cuda(model: Model, qpos, qvel, target, chol, kp: float, dt: float,
                  n_substeps: int):
    """``n_substeps`` substeps in ONE launch of the substeps kernel, on
    the current stream (same signature as :func:`substeps_plain`)."""
    return ControlStepPlan(model, kp, dt, n_substeps).substeps_cuda(qpos, qvel, target, chol)


# Counted in ControlStepPlan.cuda / .sample_planes_cuda / .substeps_cuda,
# where each kernel launches.
control_step_cuda.launches = 0
plane_sampler_cuda.launches = 0
substeps_cuda.launches = 0


def make_control_step_runner(
    model: Model,
    kp: float,
    dt: float,
    n_substeps: int,
    exact: bool = False,
    *,
    terrain: Union[Terrain, HeightGrid, None] = None,
    dr_fields: Sequence[str] = (),
    has_push: bool = False,
) -> ControlStepPlan:
    """``run(qpos[B, nq], qvel[B, nv], target[B, nj][, extra[B, n_extra]])
    -> (qpos', qvel', normals[B, n_geoms])`` for one env configuration:
    one kernel launch per control step on CUDA tensors, the plain version
    on CPU tensors. ``exact`` rebuilds the factor at every substep (exact
    dynamics instead of the held-factor approximation). ``terrain`` is an
    analytic ``Terrain`` (wave sums inside the kernel) or a ``HeightGrid``:
    then the runner first samples each ground geom's tangent plane (the
    plane-sampler kernel, one more launch) and the control step holds the
    planes frozen over its substeps. ``extra`` is ``[len(dr_fields) +
    3·has_push]`` wide; when both are off the runner takes three
    arguments. The runner is the (callable) plan."""
    return ControlStepPlan(model, kp, dt, n_substeps, exact, terrain=terrain,
                           dr_fields=dr_fields, has_push=has_push)


class SubstepRunner:
    """``run(qpos, qvel, target, chol[B, nv, nv])`` over ``n_substeps``
    substeps, ``substeps_per_kernel`` of them per launch."""

    def __init__(self, model: Model, kp: float, dt: float, n_substeps: int,
                 substeps_per_kernel: int = 1):
        if substeps_per_kernel in (0, -1):
            substeps_per_kernel = n_substeps
        if substeps_per_kernel < 1 or n_substeps % substeps_per_kernel != 0:
            raise ValueError(
                f"n_substeps ({n_substeps}) must be a multiple of "
                f"substeps_per_kernel ({substeps_per_kernel})"
            )
        self.n_substeps = int(n_substeps)
        self.substeps_per_kernel = int(substeps_per_kernel)
        self.plan = ControlStepPlan(model, kp, dt, self.substeps_per_kernel)

    def __call__(self, qpos, qvel, target, chol):
        device = qpos.device
        if device.type == "cuda":
            step = self.plan.substeps_cuda
        elif device.type == "cpu":
            step = self.plan.substeps_plain
        else:
            raise ValueError(f"the substeps have no implementation for device {device}")
        return step(qpos, qvel, target, chol, self.n_substeps // self.substeps_per_kernel)


def make_substep_runner(model: Model, kp: float, dt: float, n_substeps: int,
                        substeps_per_kernel: int = 1) -> SubstepRunner:
    """``run(qpos[B, nq], qvel[B, nv], target[B, nj], chol[B, nv, nv]) ->
    (qpos', qvel', normals[B, n_geoms])`` with the lower Cholesky factor
    of ``M + dt·D`` built by the caller and held over the control step
    (``pallas_step.py::make_substep_runner``): ``n_substeps /
    substeps_per_kernel`` launches of the substeps kernel on CUDA tensors,
    the plain version on CPU tensors. ``substeps_per_kernel`` of 0 or -1
    means all of them in one launch; ``n_substeps`` must be a multiple."""
    return SubstepRunner(model, kp, dt, n_substeps, substeps_per_kernel)
