"""The schedules that the physics kernels' lane groups walk, and a host
rehearsal of the kernels themselves.

``pack_params`` and ``pack_scene_params`` carry, beside the models, the
order in which a group of lanes per env walks the tree: the bodies of each
depth level, each body's children in descending order, each body's contact
wrenches in the plain versions' order, and the trees' dof ranges. The first
tests check that these cover every body, geom, pair and dof once, in an
order that keeps every sum of the plain versions in its order.

The host rehearsal compiles ``csrc/control_step.cu`` and
``csrc/scene_step.cu`` with g++ against ``tests/cuda_host_stub.h``, a stub
of the CUDA runtime that runs each block's threads as ``std::thread``s with
barriers for ``__syncwarp`` and ``__syncthreads`` and one shared-memory
buffer per block, and holds the kernels at 4 lanes per env, with an env
group past the batch, to their plain versions at the tolerances of
``tests/test_torch_gpu.py`` (glibc's ``sinf``, ``cosf`` and ``sqrtf`` differ
from PyTorch's CPU kernels in the last bit). Every compile and run has a
time limit, so that a lane that misses a barrier fails the test instead of
hanging it. It skips without g++.

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
from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
from nnx_ppo_tpu_torch.physics.testing import (
    general_tree,
    general_tree_states,
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


def scene_plan() -> SceneStepPlan:
    plan = SceneStepPlan((general_tree(), slider_tree()), ((0, 0, 1, 0), (1, 1, 0, 2)), 0.002, 3)
    plan.group_size = GROUP
    return plan


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """Both kernels compiled for the host, in parallel: name -> (binary,
    build directory)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: no host rehearsal of the CUDA kernels")
    specs = {
        "control_step": control_plans()["held"].kernel_spec[1],
        "scene_step": scene_plan().kernel_spec[1],
    }
    assert control_plans()["substeps"].kernel_spec == control_plans()["held"].kernel_spec
    procs = {}
    for name, flags in specs.items():
        build = tmp_path_factory.mktemp(name)
        shutil.copy(STUB, build / "cuda_runtime.h")
        (build / "kernel.cu").write_text(host_source(name))
        (build / "main.cpp").write_text(HOST_MAIN % {"call": CALLS[name]})
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


def run_host(host_kernels, source: str, entry: str, params, inputs, widths) -> list[torch.Tensor]:
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
        [str(binary), entry, str(run_dir), str(B), str(THREADS), *map(str, widths)],
        capture_output=True, text=True, timeout=RUN_SECONDS,
    )
    assert done.returncode == 0, f"{entry}: exit {done.returncode}\n{done.stderr}"
    return [torch.from_numpy(np.fromfile(run_dir / f"out{k}.bin", np.float32).reshape(B, w))
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
