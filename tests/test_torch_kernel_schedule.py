"""The schedules that the physics kernels' lane groups walk, and a host
rehearsal of the kernels themselves.

``pack_params`` and ``pack_scene_params`` carry, beside the models, the
order in which a group of lanes per env walks the tree: the bodies of each
depth level, each body's children in descending order, each body's contact
wrenches in the plain versions' order, and the trees' dof ranges. The first
tests check that these cover every body, geom, pair and dof once, in an
order that keeps every sum of the plain versions in its order.

The host rehearsal compiles ``csrc/control_step.cu``,
``csrc/scene_step.cu``, ``csrc/gae.cu`` and ``csrc/plane_sampler.cu`` with
g++ against ``tests/cuda_host_stub.h``, a stub of the CUDA runtime that
runs each block's threads as ``std::thread``s with barriers for
``__syncwarp`` and ``__syncthreads``, one shared-memory buffer per block
and a plain copy for ``cp.async``, and holds the kernels to their plain
versions: the physics kernels at 4 lanes per env, with an env group past
the batch, and the control step also at the humanoid's sizes and 16 lanes
per env (``nv = 16``: one row of the forward solve per lane, the branch
the quadruped's ``nv = 18`` never takes), at the tolerances of
``tests/test_torch_gpu.py`` (glibc's
``sinf``, ``cosf`` and ``sqrtf`` differ from PyTorch's CPU kernels in the
last bit); the plane sampler at 4 and 8 lanes per env with a ragged last
block, on the data-terrain table and on a small one that some envs stand
outside of; GAE at ``[7, 33]`` and ``[7, 64]`` with up to three keys in one
launch, bool and float flags, a column slice of a wider tensor and rows
staged in tiles, to the bit. Every compile and run has a time limit, so
that a lane that misses a barrier fails the test instead of hanging it.
It skips without g++.

    python -m pytest tests/test_torch_kernel_schedule.py -q
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nnx_ppo_tpu_torch.envs.pusher import _make_ball
from nnx_ppo_tpu_torch.ops.cuda_build import CSRC_DIR
from nnx_ppo_tpu_torch.physics.cuda_scene_step import SceneStepPlan, pack_scene_params
from nnx_ppo_tpu_torch.physics.cuda_step import ControlStepPlan, pack_factor, pack_params
from nnx_ppo_tpu_torch.physics.engine import mass_matrix_factor
from nnx_ppo_tpu_torch.physics.models.arm import make_arm
from nnx_ppo_tpu_torch.physics.models.humanoid import make_humanoid
from nnx_ppo_tpu_torch.ops.gae import gae_scan
from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid, rough_terrain
from nnx_ppo_tpu_torch.physics.testing import (
    general_tree,
    general_tree_states,
    humanoid_states,
    slider_tree,
    slider_tree_states,
    standing_states,
)

STUB = Path(__file__).with_name("cuda_host_stub.h")
# Lanes per env and threads per block of the rehearsal: 3 envs in a block
# of 8 groups, so that 5 groups run past the batch.
GROUP, THREADS, B = 4, 32, 3
COMPILE_SECONDS, RUN_SECONDS = 240, 60
DR_FIELDS = ("mass_scale", "friction", "damping_scale", "gain_scale")


# -- the schedules ----------------------------------------------------------------


def _ints(array, n: int) -> list[int]:
    return [int(x) for x in list(array)[:n]]


def check_schedule(p, parent, geom_body, pair_a, pair_b, *, children: bool) -> None:
    """Levels cover every body once, each a level below its parent, in index
    order; children (where packed) in descending order; each body's contact
    slots in the plain order, every geom and each pair's two sides once."""
    nb = len(parent)
    starts = _ints(p.level_start, p.n_levels + 1)
    bodies = _ints(p.level_body, nb)
    assert sorted(bodies) == list(range(nb)) and starts[0] == 0 and starts[-1] == nb
    level_of = {}
    for level in range(p.n_levels):
        members = bodies[starts[level]:starts[level + 1]]
        assert members and members == sorted(members)
        level_of.update({b: level for b in members})
    for i, par in enumerate(parent):
        assert level_of[i] == (0 if par < 0 else level_of[par] + 1)
    if children:
        child_start, child_list = _ints(p.child_start, nb + 1), list(p.child_list)
        listed = []
        for i in range(nb):
            kids = [int(c) for c in child_list[child_start[i]:child_start[i + 1]]]
            assert kids == [c for c in reversed(range(nb)) if parent[c] == i]
            listed += kids
        assert sorted(listed) == [i for i in range(nb) if parent[i] >= 0]
    ng, n_pairs = len(geom_body), len(pair_a)
    contact_start, slots = _ints(p.contact_start, nb + 1), list(p.contact_slot)
    seen = []
    for i in range(nb):
        got = [int(x) for x in slots[contact_start[i]:contact_start[i + 1]]]
        want = [g for g in range(ng) if geom_body[g] == i]
        for k in range(n_pairs):
            want += [ng + 2 * k] * (pair_b[k] == i) + [ng + 2 * k + 1] * (pair_a[k] == i)
        assert got == want
        seen += got
    assert sorted(seen) == list(range(ng + 2 * n_pairs))


def test_quadruped_schedule_covers_every_body_geom_and_pair_once():
    model = make_quadruped(self_collision=True, joint_limits=True)
    p = pack_params(ControlStepPlan(model, 60.0, 0.002, 10))
    assert p.n_levels == 4 and _ints(p.level_start, 5) == [0, 1, 5, 9, 13]
    gb = list(model.geom_body)
    check_schedule(p, list(model.parent), gb, [gb[g] for g in model.pair_geom_a],
                   [gb[g] for g in model.pair_geom_b], children=True)
    assert _ints(p.child_list, 4) == [10, 7, 4, 1]  # the trunk's legs, last first


def test_humanoid_schedule_covers_every_body_geom_pair_and_dof_once():
    """Leaves at two depths (the arms at 1, the feet at 4): levels of
    widths 1, 4, 2, 2, 2; the four foot-foot pairs join bodies of two
    subtrees of the trunk; each dof's row owned by one lane, at the
    shipped 16 lanes per env."""
    model = make_humanoid(self_collision=True, joint_limits=True)
    plan = ControlStepPlan(model, 350.0, 0.002, 10, True)
    p = pack_params(plan)
    assert p.n_levels == 5 and _ints(p.level_start, 6) == [0, 1, 5, 7, 9, 11]
    assert _ints(p.level_body, 11) == [0, 1, 5, 9, 10, 2, 6, 3, 7, 4, 8]
    gb = list(model.geom_body)
    check_schedule(p, list(model.parent), gb, [gb[g] for g in model.pair_geom_a],
                   [gb[g] for g in model.pair_geom_b], children=True)
    assert _ints(p.child_list, 4) == [10, 9, 5, 1]  # the trunk's arms and legs, last first
    # Ground slots 0-5, then 2 x 4 pair slots on the two feet (bodies 4, 8).
    starts = _ints(p.contact_start, 12)
    assert [starts[i + 1] - starts[i] for i in range(11)] == [2, 0, 0, 0, 6, 0, 0, 0, 6, 0, 0]
    # The rows as the kernel sizes and shares them out (rigid_body.cuh,
    # control_step.cu): CS_NV = 6 + CS_NJ, the base's rows 0-5 and row
    # 5 + i of body i's hinge; the forward solve gives lane l the rows
    # l + q * CS_G for q < kRows; the factor, below column j, the rows
    # first_owned_row(j + 1, l), then every CS_G-th.
    sizes = plan.sizes
    nv, G = 6 + (sizes["CS_NB"] - 1), sizes["CS_G"]
    assert nv == model.nv == 16
    assert sorted(list(range(6)) + [5 + i for i in range(1, sizes["CS_NB"])]) == list(range(nv))
    k_rows = (nv + G - 1) // G
    assert (G, k_rows) == (16, 1)  # one row per lane: the branch nv = 18 never takes
    owned = [lane + q * G for lane in range(G) for q in range(k_rows) if lane + q * G < nv]
    assert sorted(owned) == list(range(nv))

    def first_owned_row(after: int, lane: int) -> int:
        return after + ((lane - after % G) + G) % G

    for j in range(nv - 1):
        below = [i for lane in range(G) for i in range(first_owned_row(j + 1, lane), nv, G)]
        assert sorted(below) == list(range(j + 1, nv))


SCENES = {
    "arm": lambda: ((make_arm(),), ()),
    "ball": lambda: ((_make_ball(),), ()),
    "general_tree": lambda: ((general_tree(),), ()),
    "arm_and_ball": lambda: ((make_arm(), _make_ball()), ((0, 0, 1, 0),)),
    "general_and_slider_trees": lambda: (
        (general_tree(), slider_tree()), ((0, 0, 1, 0), (1, 1, 0, 2))
    ),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_scene_schedule_covers_every_body_geom_pair_and_dof_once(scene):
    models, pairs = SCENES[scene]()
    plan = SceneStepPlan(models, pairs, 0.002, 1)
    p = pack_scene_params(plan)
    nb, nv, nt = plan.sizes["SS_NB"], plan.nv, len(models)
    parent = _ints(p.parent, nb)
    geom_body = _ints(p.geom_body, plan.sizes["SS_NG"])
    n_pairs = plan.sizes["SS_NP"]
    pair_a = [geom_body[g] for g in _ints(p.pair_a, n_pairs)]
    pair_b = [geom_body[g] for g in _ints(p.pair_b, n_pairs)]
    check_schedule(p, parent, geom_body, pair_a, pair_b, children=False)
    # The trees' body and dof ranges tile the scene, each tree's bodies'
    # dofs inside its own range.
    assert _ints(p.tree_body_start, nt) + [nb] == [0] + _ints(p.tree_body_end, nt)
    assert _ints(p.tree_v_start, nt) + [nv] == list(np.cumsum([0] + _ints(p.tree_nv, nt)))
    for t in range(nt):
        lo, hi = p.tree_v_start[t], p.tree_v_start[t] + p.tree_nv[t]
        dofs = [p.v_start[i] + d for i in range(p.tree_body_start[t], p.tree_body_end[t])
                for d in range(p.n_dof[i])]
        assert dofs == list(range(lo, hi))


# -- the host rehearsal -----------------------------------------------------------

HOST_MAIN = r"""
#include "cuda_runtime.h"
#include "kernel.cu"

#include <string>

// entry dir B threads width0 width1 width2: reads params.bin and
// in0.bin .. in3.bin (absent = null), writes out0.bin .. out2.bin.
int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const std::string entry = argv[1], dir = argv[2];
  const int B = std::atoi(argv[3]), threads = std::atoi(argv[4]);
  const std::vector<char> params = stub_read((dir + "/params.bin").c_str());
  std::vector<std::vector<char>> in;
  for (int k = 0; k < 4; ++k) in.push_back(stub_read((dir + "/in" + std::to_string(k) + ".bin").c_str()));
  auto f = [&](int k) { return in[k].empty() ? nullptr : reinterpret_cast<const float*>(in[k].data()); };
  std::vector<std::vector<float>> out;
  for (int k = 0; k < 3; ++k) out.emplace_back(static_cast<size_t>(B) * std::atoi(argv[5 + k]));
  const int err = %(call)s;
  for (int k = 0; k < 3; ++k)
    stub_write((dir + "/out" + std::to_string(k) + ".bin").c_str(), out[k].data(), out[k].size() * 4);
  return err;
}
"""
CALLS = {
    "control_step": (
        "(entry == \"substeps\" ? substeps_forward : control_step_forward)(f(0), f(1), f(2), "
        "f(3), out[0].data(), out[1].data(), out[2].data(), B, "
        "reinterpret_cast<const Params*>(params.data()), threads, 0, nullptr)"
    ),
    "scene_step": (
        "scene_step_forward(f(0), f(1), f(2), out[0].data(), out[1].data(), out[2].data(), B, "
        "reinterpret_cast<const SceneParams*>(params.data()), threads, 0, nullptr)"
    ),
}


def host_source(name: str) -> str:
    """``csrc/<name>.cu`` with its launch and its dynamic shared memory
    spelled for the stub."""
    text = (CSRC_DIR / f"{name}.cu").read_text()
    text, n_launches = re.subn(r"(\w+)<<<(.*?)>>>\(", r"stub_launch(\1, \2, ", text, flags=re.S)
    text, n_shared = re.subn(
        r"extern __shared__ (\w+) (\w+)\[\];",
        r"\1* \2 = reinterpret_cast<\1*>(stub_shared_memory());", text,
    )
    assert n_launches >= 1 and n_shared >= 1 and "<<<" not in text
    return text


def control_plans():
    model = make_quadruped(self_collision=True, joint_limits=True)
    plans = {
        "held": ControlStepPlan(model, 60.0, 0.002, 10, dr_fields=DR_FIELDS, has_push=True,
                                n_terrain_planes=8),
        "exact": ControlStepPlan(model, 60.0, 0.002, 10, True, dr_fields=DR_FIELDS,
                                 has_push=True, n_terrain_planes=8),
        "substeps": ControlStepPlan(model, 60.0, 0.002, 10),
    }
    for plan in plans.values():
        plan.group_size = GROUP
    return plans


# The humanoid at its own sizes and the shipped 16 lanes per env, so that
# nv = 16 gives one row per lane in the forward solve (kRows == 1); two envs
# a block, three envs, so that the second block's second group runs past
# the batch.
HUMANOID_GROUP, HUMANOID_THREADS = 16, 32


def humanoid_plans():
    model = make_humanoid(self_collision=True, joint_limits=True)
    return {mode: ControlStepPlan(model, 350.0, 0.002, 10, mode == "exact")
            for mode in ("held", "exact")}


def scene_plan() -> SceneStepPlan:
    plan = SceneStepPlan((general_tree(), slider_tree()), ((0, 0, 1, 0), (1, 1, 0, 2)), 0.002, 3)
    plan.group_size = GROUP
    return plan


GAE_MAIN = r"""
#include "cuda_runtime.h"
#include "kernel.cu"

#include <string>

// dir n_keys T B ld done_is_bool truncation_is_bool columns tile_rows gamma
// lambda batch_major: reads {rewards,values,last,done,truncation}<k>.bin
// (the [T, B] inputs, or [B, T] batch-major, at row stride ld), writes
// out<k>.bin.
int main(int argc, char** argv) {
  if (argc != 13) return 2;
  const std::string dir = argv[1];
  const int n = std::atoi(argv[2]), T = std::atoi(argv[3]), B = std::atoi(argv[4]);
  const long long ld = std::atoll(argv[5]);
  const float gamma = static_cast<float>(std::strtod(argv[10], nullptr));
  const float lambda = static_cast<float>(std::strtod(argv[11], nullptr));
  const char* names[] = {"rewards", "values", "last", "done", "truncation"};
  std::vector<std::vector<char>> in;
  for (int k = 0; k < n; ++k)
    for (const char* name : names)
      in.push_back(stub_read((dir + "/" + name + std::to_string(k) + ".bin").c_str()));
  std::vector<std::vector<float>> out(n, std::vector<float>(static_cast<size_t>(T) * B));
  std::vector<long long> words;
  for (int k = 0; k < n; ++k) {
    for (int j = 0; j < 5; ++j) words.push_back(reinterpret_cast<long long>(in[5 * k + j].data()));
    words.push_back(reinterpret_cast<long long>(out[k].data()));
    for (int j = 0; j < 4; ++j) words.push_back(ld);
  }
  const int err = gae_forward(words.data(), n, T, B, gamma, lambda, std::atoi(argv[6]),
                              std::atoi(argv[7]), std::atoi(argv[12]), std::atoi(argv[8]),
                              std::atoi(argv[9]), 0, nullptr);
  for (int k = 0; k < n; ++k)
    stub_write((dir + "/out" + std::to_string(k) + ".bin").c_str(), out[k].data(), out[k].size() * 4);
  return err;
}
"""
SAMPLER_MAIN = r"""
#include "cuda_runtime.h"
#include "kernel.cu"

#include <string>

// dir B threads nx ny x0 y0 inv_dx inv_dy: reads params.bin, qpos.bin and
// table.bin, writes planes.bin.
int main(int argc, char** argv) {
  if (argc != 10) return 2;
  const std::string dir = argv[1];
  const int B = std::atoi(argv[2]), threads = std::atoi(argv[3]);
  float consts[4];
  for (int k = 0; k < 4; ++k) consts[k] = static_cast<float>(std::strtod(argv[6 + k], nullptr));
  const std::vector<char> params = stub_read((dir + "/params.bin").c_str());
  const std::vector<char> qpos = stub_read((dir + "/qpos.bin").c_str());
  const std::vector<char> table = stub_read((dir + "/table.bin").c_str());
  std::vector<float> planes(static_cast<size_t>(B) * 3 * CS_NG);
  const int err = plane_sampler_forward(
      reinterpret_cast<const float*>(qpos.data()), reinterpret_cast<const float*>(table.data()),
      planes.data(), B, std::atoi(argv[4]), std::atoi(argv[5]), consts[0], consts[1], consts[2],
      consts[3], reinterpret_cast<const Params*>(params.data()), threads, 0, nullptr);
  stub_write((dir + "/planes.bin").c_str(), planes.data(), planes.size() * 4);
  return err;
}
"""
# (lanes per env, threads per block) of the sampler's rehearsal: 16 envs a
# block, so that 33 envs end one env into the third block.
SAMPLER_LAUNCHES = {4: 64, 8: 128}
SAMPLER_B = 33


def sampler_plan(group: int, n: int, extent: float) -> ControlStepPlan:
    grid = HeightGrid.sample(rough_terrain(seed=2, amplitude=0.03, wavelength=1.5),
                             extent=extent, n=n)
    plan = ControlStepPlan(make_quadruped(), 60.0, 0.002, 10, terrain=grid)
    plan.sampler_group, plan.sampler_threads = group, SAMPLER_LAUNCHES[group]
    return plan


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """Both kernels compiled for the host, in parallel: name -> (binary,
    build directory)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: no host rehearsal of the CUDA kernels")
    # name -> (source, flags, host program).
    specs = {
        "control_step": ("control_step", control_plans()["held"].kernel_spec[1],
                         HOST_MAIN % {"call": CALLS["control_step"]}),
        "control_step_humanoid": ("control_step", humanoid_plans()["held"].kernel_spec[1],
                                  HOST_MAIN % {"call": CALLS["control_step"]}),
        "scene_step": ("scene_step", scene_plan().kernel_spec[1],
                       HOST_MAIN % {"call": CALLS["scene_step"]}),
        "gae": ("gae", (), GAE_MAIN),
    }
    for group in SAMPLER_LAUNCHES:
        specs[f"plane_sampler_G{group}"] = ("plane_sampler",
                                            sampler_plan(group, 32, 3.0).sampler_spec[1],
                                            SAMPLER_MAIN)
    assert control_plans()["substeps"].kernel_spec == control_plans()["held"].kernel_spec
    assert humanoid_plans()["exact"].kernel_spec == humanoid_plans()["held"].kernel_spec
    assert humanoid_plans()["held"].sizes["CS_G"] == HUMANOID_GROUP == make_humanoid().nv
    procs = {}
    for name, (source, flags, main) in specs.items():
        build = tmp_path_factory.mktemp(name)
        shutil.copy(STUB, build / "cuda_runtime.h")
        (build / "kernel.cu").write_text(host_source(source))
        (build / "main.cpp").write_text(main)
        defines = [f for f in flags if f.startswith("-D")]
        cmd = [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-pthread", "-w",
               f"-I{build}", f"-I{CSRC_DIR}", *defines, "-o", str(build / "kernel"),
               str(build / "main.cpp")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), build)
    out = {}
    for name, (proc, build) in procs.items():
        try:
            log, _ = proc.communicate(timeout=COMPILE_SECONDS)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"g++ {name}.cu:\n{log}"
        out[name] = (build / "kernel", build)
    return out


def run_host(host_kernels, source: str, entry: str, params, inputs, widths, batch: int = B,
             threads: int = THREADS) -> list[torch.Tensor]:
    binary, build = host_kernels[source]
    run_dir = build / entry
    run_dir.mkdir(exist_ok=True)
    (run_dir / "params.bin").write_bytes(bytes(params))
    for k in range(4):
        path = run_dir / f"in{k}.bin"
        path.unlink(missing_ok=True)
        if k < len(inputs) and inputs[k] is not None:
            np.ascontiguousarray(inputs[k], np.float32).tofile(path)
    done = subprocess.run(
        [str(binary), entry, str(run_dir), str(batch), str(threads), *map(str, widths)],
        capture_output=True, text=True, timeout=RUN_SECONDS,
    )
    assert done.returncode == 0, f"{entry}: exit {done.returncode}\n{done.stderr}"
    return [torch.from_numpy(np.fromfile(run_dir / f"out{k}.bin", np.float32).reshape(batch, w))
            for k, w in enumerate(widths)]


def quadruped_arrays(model):
    """Three envs: front feet pressed together (a pair in contact) in envs 0
    and 2, a joint past its stop in env 1, a gentle tangent plane under
    every geom."""
    arrays = standing_states(model, default_qpos(model), B, seed=3, n_extra_dr=4, has_push=True)
    arrays["qpos"][::2, 7:13] = [0.38, 0.8, -1.6, -0.38, 0.8, -1.6]
    arrays["target"][::2, 0:6] = [0.6, 0.8, -1.6, -0.6, 0.8, -1.6]
    arrays["qpos"][1, 13], arrays["target"][1, 6], arrays["qpos"][1, 15] = 0.9, 1.2, -0.88
    rng = np.random.RandomState(9)
    planes = np.concatenate([0.005 * rng.randn(B, 8, 1), 0.05 * rng.randn(B, 8, 2)], axis=-1)
    arrays["extra"] = np.concatenate([arrays["extra"], planes.reshape(B, 24)], axis=1)
    arrays["extra"] = arrays["extra"].astype(np.float32)
    return arrays


def assert_control_step_close(got, want):
    """Ten substeps: qpos 2e-4, qvel 2e-3, normals rtol 5e-3 / atol 5e-2."""
    assert all(torch.isfinite(x).all() for x in got)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-4)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=2e-3)
    torch.testing.assert_close(got[2], want[2], rtol=5e-3, atol=5e-2)


@pytest.mark.parametrize("mode", ["held", "exact"])
def test_control_step_kernel_on_the_host_matches_plain_version(host_kernels, mode):
    torch.set_num_threads(1)
    plan = control_plans()[mode]
    arrays = quadruped_arrays(plan.model)
    args = [torch.from_numpy(arrays[k]) for k in ("qpos", "qvel", "target", "extra")]
    want = plan.plain(*args)
    assert (want[2][:, :8] > 0).any() and (want[2][:, 8:] > 0).any()  # ground and a pair
    widths = (plan.model.nq, plan.model.nv, plan.n_geoms)
    got = run_host(host_kernels, "control_step", "control_step", pack_params(plan),
                   [arrays[k] for k in ("qpos", "qvel", "target", "extra")], widths)
    assert_control_step_close(got, want)


@pytest.mark.parametrize("mode", ["held", "exact"])
def test_control_step_kernel_on_the_host_at_the_humanoids_sizes(host_kernels, mode):
    """The humanoid with self-collision and joint limits, 16 lanes per env
    (one row of the forward solve per lane), ten substeps: feet on the
    ground, the feet's spheres pressed together, a knee past its stop;
    qpos 2e-4, qvel 2e-3, normals rtol 5e-3 / atol 5e-2, the quadruped's
    tolerances (glibc's sinf, cosf and sqrtf against PyTorch's)."""
    torch.set_num_threads(1)
    plan = humanoid_plans()[mode]
    arrays = humanoid_states(plan.model, B, seed=3)
    args = [torch.from_numpy(arrays[k]) for k in ("qpos", "qvel", "target")]
    want = plan.plain(*args)
    assert (want[2][:, :6] > 0).any() and (want[2][:, 6:] > 0).any()  # ground and a pair
    widths = (plan.model.nq, plan.model.nv, plan.n_geoms)
    got = run_host(host_kernels, "control_step_humanoid", f"humanoid_{mode}", pack_params(plan),
                   [arrays[k] for k in ("qpos", "qvel", "target")], widths,
                   threads=HUMANOID_THREADS)
    assert_control_step_close(got, want)


def test_substeps_kernel_on_the_host_matches_plain_version(host_kernels):
    torch.set_num_threads(1)
    plan = control_plans()["substeps"]
    model = plan.model
    arrays = standing_states(model, default_qpos(model), B, seed=3)
    args = [torch.from_numpy(arrays[k]) for k in ("qpos", "qvel", "target")]
    chol = mass_matrix_factor(model, args[0], dt=0.002)
    want = plan.substeps_plain(*args, chol)
    widths = (model.nq, model.nv, plan.n_geoms)
    got = run_host(host_kernels, "control_step", "substeps", pack_params(plan),
                   [arrays[k] for k in ("qpos", "qvel", "target")] + [pack_factor(chol).numpy()],
                   widths)
    assert_control_step_close(got, want)


def test_scene_step_kernel_on_the_host_matches_plain_version(host_kernels):
    """Every joint type, a pair inside a tree, two cross pairs, three
    substeps: qpos 2e-5, qvel 5e-4, normals 1e-4 (rtol = atol)."""
    torch.set_num_threads(1)
    plan = scene_plan()
    parts = [general_tree_states(B, seed=1), slider_tree_states(B, seed=2)]
    arrays = {k: np.concatenate([p[k] for p in parts], axis=1) for k in ("qpos", "qvel", "tau")}
    args = [torch.from_numpy(arrays[k]) for k in ("qpos", "qvel", "tau")]
    want = plan.plain(*args)
    got = run_host(host_kernels, "scene_step", "scene_step", pack_scene_params(plan),
                   [arrays[k] for k in ("qpos", "qvel", "tau")], (plan.nq, plan.nv, plan.n_normals))
    assert all(torch.isfinite(x).all() for x in got)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got[1], want[1], rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)


# -- GAE and the plane sampler on the host ----------------------------------------


def run_gae_host(host_kernels, label, keys, T, B, ld, flag_dtypes, tile_rows, lam, gamma,
                 batch_major=False):
    """The host-built GAE kernel on ``keys`` (per key: rewards, values,
    last value, done, truncation as numpy, the [T, B] ones, or [B, T] with
    ``batch_major``, at row stride ``ld``) in one launch; returns the
    advantages per key in the same layout."""
    binary, build = host_kernels["gae"]
    run_dir = build / label
    run_dir.mkdir(exist_ok=True)
    names = ("rewards", "values", "last", "done", "truncation")
    for k, key in enumerate(keys):
        for name, x in zip(names, key):
            dtype = np.float32 if name not in ("done", "truncation") else (
                np.bool_ if flag_dtypes[names.index(name) - 3] == torch.bool else np.float32)
            np.ascontiguousarray(x, dtype).tofile(run_dir / f"{name}{k}.bin")
    bools = [int(d == torch.bool) for d in flag_dtypes]
    done = subprocess.run(
        [str(binary), str(run_dir), str(len(keys)), str(T), str(B), str(ld), *map(str, bools),
         "32", str(tile_rows), float(gamma).hex(), float(lam).hex(), str(int(batch_major))],
        capture_output=True, text=True, timeout=RUN_SECONDS,
    )
    assert done.returncode == 0, f"gae {label}: exit {done.returncode}\n{done.stderr}"
    shape = (B, T) if batch_major else (T, B)
    return [torch.from_numpy(np.fromfile(run_dir / f"out{k}.bin", np.float32).reshape(shape))
            for k in range(len(keys))]


# name -> (T, B, row stride, keys, shared done, (done dtype, truncation dtype), tile rows).
# [7, 33] ends one column into its second block (4- and 1-byte copies); [7,
# 64] stages 16-byte copies; the slice reads 40 columns of rows 48 wide;
# tile_rows 3 stages the 7 rows as 3 + 3 + 1.
GAE_HOST_CASES = {
    "7x33_three_keys_bool": (7, 33, 33, 3, False, (torch.bool, torch.bool), 0),
    "7x33_three_keys_float_done_bool_trunc": (7, 33, 33, 3, False, (torch.float32, torch.bool), 0),
    "7x64_two_keys_shared_done": (7, 64, 64, 2, True, (torch.bool, torch.bool), 0),
    "7x40_column_slice_of_48": (7, 40, 48, 1, False, (torch.float32, torch.float32), 0),
    "7x33_rows_in_tiles_of_3": (7, 33, 33, 2, False, (torch.bool, torch.float32), 3),
}


@pytest.mark.parametrize("case", list(GAE_HOST_CASES))
def test_gae_kernel_on_the_host_matches_plain_version_to_the_bit(host_kernels, case):
    """Every key's output equals gae_scan's bits: the kernel runs the plain
    version's float32 operations, each rounded on its own, in its order."""
    T, B, ld, n_keys, shared, flag_dtypes, tile_rows = GAE_HOST_CASES[case]
    rng = np.random.RandomState(len(case))
    lam, gamma = 0.95, 0.99
    keys, wants = [], []
    shared_flags = None
    for _ in range(n_keys):
        done = rng.rand(T, ld) < 0.15
        truncated = done & (rng.rand(T, ld) < 0.5)
        if shared:
            shared_flags = shared_flags or (done, truncated)
            done, truncated = shared_flags
        wide = [rng.randn(T, ld).astype(np.float32), rng.randn(T, ld).astype(np.float32)]
        last = rng.randn(B).astype(np.float32)
        keys.append((wide[0], wide[1], last, done, truncated))
        cols = [torch.from_numpy(np.ascontiguousarray(x[:, :B])) for x in (*wide, done, truncated)]
        wants.append(gae_scan(cols[0], cols[1], torch.from_numpy(last),
                              cols[2].to(flag_dtypes[0]), cols[3].to(flag_dtypes[1]), lam, gamma))
    assert any(bool(k[4][:, :B].any()) for k in keys)  # some truncations
    got = run_gae_host(host_kernels, case, keys, T, B, ld, flag_dtypes, tile_rows, lam, gamma)
    for g, w in zip(got, wants):
        assert torch.equal(g, w), f"max abs error {(g - w).abs().max().item():.3g}"


# Batch-major: name -> (T, B, row stride, keys, (done dtype, truncation
# dtype), tile rows). [20, 33] x 2 is the bf16-store path's minibatch at a
# ragged width (one 16-byte span per block, the last block one env; its
# bool flags end in single bytes); [30, 48] rows 32 apart (a step slice of
# a wider buffer: per-env segments); tile_rows 8 stages 20 steps as 4 + 8 +
# 8 in segments of each env.
GAE_HOST_BATCH_MAJOR_CASES = {
    "20x33_two_keys_bool": (20, 33, 20, 2, (torch.bool, torch.bool), 0),
    "30x48_float_flags_rows_of_32": (30, 48, 32, 1, (torch.float32, torch.float32), 0),
    "7x33_three_keys_float_done": (7, 33, 7, 3, (torch.float32, torch.bool), 0),
    "20x40_steps_in_tiles_of_8": (20, 40, 20, 2, (torch.bool, torch.float32), 8),
}


@pytest.mark.parametrize("case", list(GAE_HOST_BATCH_MAJOR_CASES))
def test_gae_kernel_on_the_host_reads_batch_major_keys_to_the_bit(host_kernels, case):
    """[B, T] inputs read in place and [B, T] advantages: every key equals
    gae_scan on the transposed views to the bit (ppo_loss's plain path
    for a batch-major minibatch)."""
    T, B, ld, n_keys, flag_dtypes, tile_rows = GAE_HOST_BATCH_MAJOR_CASES[case]
    rng = np.random.RandomState(len(case))
    lam, gamma = 0.95, 0.99
    keys, wants = [], []
    for _ in range(n_keys):
        done = rng.rand(B, ld) < 0.15
        truncated = done & (rng.rand(B, ld) < 0.5)
        wide = [rng.randn(B, ld).astype(np.float32), rng.randn(B, ld).astype(np.float32)]
        last = rng.randn(B).astype(np.float32)
        keys.append((wide[0], wide[1], last, done, truncated))
        rows = [torch.from_numpy(np.ascontiguousarray(x[:, :T])) for x in (*wide, done, truncated)]
        wants.append(gae_scan(rows[0].T, rows[1].T, torch.from_numpy(last),
                              rows[2].to(flag_dtypes[0]).T, rows[3].to(flag_dtypes[1]).T,
                              lam, gamma).T)
    assert any(bool(k[4][:, :T].any()) for k in keys)  # some truncations
    got = run_gae_host(host_kernels, case, keys, T, B, ld, flag_dtypes, tile_rows, lam, gamma,
                       batch_major=True)
    for g, w in zip(got, wants):
        assert torch.equal(g, w), f"max abs error {(g - w).abs().max().item():.3g}"


@pytest.mark.parametrize("table", ["256x256", "32x32_some_outside"])
@pytest.mark.parametrize("group", list(SAMPLER_LAUNCHES))
def test_plane_sampler_kernel_on_the_host_matches_plain_version(host_kernels, group, table):
    """33 envs, 16 a block (a ragged last block): every plane within 1e-5
    of the plain version (glibc's sinf and cosf in the kinematics against
    PyTorch's, last bits; heights and slopes are below 1)."""
    torch.set_num_threads(1)
    n, extent = (256, 12.0) if table == "256x256" else (32, 3.0)
    plan = sampler_plan(group, n, extent)
    model, grid = plan.model, plan.heightgrid
    qpos = standing_states(model, default_qpos(model), SAMPLER_B, seed=5,
                           terrain=rough_terrain(seed=2, amplitude=0.03, wavelength=1.5))["qpos"]
    qpos = qpos.astype(np.float32)
    want = plan.sample_planes_plain(torch.from_numpy(qpos))
    assert (want[:, 1::3].abs() > 1e-3).any()
    outside = (np.abs(qpos[:, :2]) > extent).any(axis=1)
    assert outside.any() == (extent < 5.0)
    binary, build = host_kernels[f"plane_sampler_G{group}"]
    run_dir = build / table
    run_dir.mkdir(exist_ok=True)
    params = bytes(pack_params(plan))  # padded to 16 bytes, as the wrapper uploads it
    (run_dir / "params.bin").write_bytes(params + bytes(-len(params) % 16))
    qpos.tofile(run_dir / "qpos.bin")
    np.asarray(grid.data, np.float32).tofile(run_dir / "table.bin")
    nx, ny = grid.shape
    consts = [float(grid.x0), float(grid.y0), 1.0 / grid.dx, 1.0 / grid.dy]
    done = subprocess.run(
        [str(binary), str(run_dir), str(SAMPLER_B), str(SAMPLER_LAUNCHES[group]), str(nx),
         str(ny), *(c.hex() for c in consts)],
        capture_output=True, text=True, timeout=RUN_SECONDS,
    )
    assert done.returncode == 0, f"plane_sampler: exit {done.returncode}\n{done.stderr}"
    got = torch.from_numpy(np.fromfile(run_dir / "planes.bin", np.float32).reshape(SAMPLER_B, 24))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
