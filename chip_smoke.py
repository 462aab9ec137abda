#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nnx_ppo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR] [--learn N] [--variants] [--phases]
    python3 chip_smoke.py --ab-kernels [--package-root DIR]

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit, from nvidia-smi;
2. build: every hand-written kernel of the training paths (GAE, the
   physics control step with its substeps entry point, the plane
   sampler, the scene control step at the pusher's and the reacher's
   sizes), compiled with nvcc from the sources in
   nnx_ppo_tpu_torch/csrc/, all at once;
3. kernels: each kernel against its plain PyTorch version on the card at
   the training paths' shapes and at ragged ones (a batch that ends inside
   a warp; for the scene kernel also a two-tree scene with every joint
   type; for GAE every reward key of a minibatch in one launch), printing
   whether each output is equal to the bit (GAE and the plane sampler
   must be), then timed with CUDA events and torch.profiler against the
   plain version, GAE and the sampler also in a CUDA graph; GAE's columns
   per block and the sampler's (lanes per env, threads per block) are
   swept, each variant equal to the bit;
4. paths, each through new_training_state and ppo_multi_step with every
   kernel's launch count set to 0 just before and read just after:
   the flagship (CartpoleBalance with a 500-step time limit, 1024 envs,
   T=30, actor 64x4, critic 256x2, obs normalization, 4 epochs x 4
   shuffled minibatches, adam); the physics leg (QuadrupedJoystick
   with domain randomization, pushes and rough terrain, held factor,
   2048 envs, T=20, Concat encoder 128+32, actor 128, two critic heads,
   GAE of both reward keys in one launch, combined advantages, shuffled
   and then contiguous minibatches); the data-terrain path (the same quadruped, net and
   config on a 256 x 256 HeightGrid sampled from the rough terrain, no
   randomization or pushes: plane sampler, then control step); and the
   passed-in-factor path (flat ground, the factor of M + dt D built
   outside the kernel, all ten substeps in one launch of the substeps
   kernel); and the two manipulation paths at 4096 envs, T=20, actor
   128x2, critic 256x2, obs normalization: the pusher (ArmPush with a
   200-step time limit: arm, free ball and their cross contact, 16
   substeps in one launch of the scene kernel) and the reacher
   (ArmReacher, 150-step limit, the arm alone, 4 substeps);
5. reference: for the flagship, the physics leg and the pusher the PPO
   loss and its gradients on the card against the same computation on
   the CPU (plain versions) for one minibatch, and against the card's
   own with one GAE launch per reward key (the same bits), and for each
   quadruped and manipulation path one env step on the card (kernels)
   against the CPU (plain versions) from the same state, action and
   draws.

It prints a ``kernels`` JSON line (each kernel's design, and its
registers, stack, spills and shared memory from ptxas and the launch), the
card line, and last ``{"ok": true, "device": {...}}``. With no CUDA device
it exits 1 and prints no result. ``--profile DIR`` also writes
torch.profiler tables of one training step of each path to DIR; ``--learn
N`` also trains the flagship for N iterations through train_ppo and prints
its eval curve; ``--variants`` also builds the control-step kernel with
fused multiply-adds and prints its error and time beside the shipped
build's, and sweeps the lanes per env and threads per block of the
control-step kernel (physics-leg shape) and of the scene kernel (pusher and
reacher shapes): each variant checked equal to the bit with the plain
version and timed with CUDA events, in one order and then the reverse;
``--phases`` also builds copies of the control-step and scene kernels that
read the SM's clock at every barrier of the first env's lanes (under
build/phase_csrc/) and prints the cycles of each phase at the paths'
shapes. ``--ab-kernels`` runs only the device line and the timing of GAE
and the plane sampler at the paths' shapes (wrapper, profiler, CUDA
graph), printing an ``ab_kernels`` JSON line; ``--package-root DIR``
imports nnx_ppo_tpu_torch from DIR instead, so that another checkout (the
parent commit's, unpacked with ``git archive``) is timed by the same
script in the same chip call.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

FLAGSHIP_STEPS_CHECKED = 2
FLAGSHIP_STEPS_TIMED = 5
PHYSICS_STEPS_CHECKED = 2
PHYSICS_STEPS_TIMED = 5
PHYSICS_STEPS_NOSHUFFLE = 3
HEIGHTGRID_STEPS_CHECKED = 2
HEIGHTGRID_STEPS_TIMED = 5
XLAFACTOR_STEPS_CHECKED = 1
XLAFACTOR_STEPS_TIMED = 3
MANIPULATION_STEPS_CHECKED = 2
MANIPULATION_STEPS_TIMED = 5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int, torch) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` back-to-back calls,
    between two CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profile_calls(fn, n: int, kernel_name: str, torch, per_call: int = 1) -> dict:
    """torch.profiler over ``n`` calls of ``fn``: device time per launch of
    the CUDA kernel whose name contains ``kernel_name`` (``per_call``
    launches a call), and every device kernel per call. The profiler can
    drop records (49 of 50 were seen for a kernel of a few microseconds,
    16 of 20 for one of a few hundred, and once none of 50), so up to half
    of the launches may be missing, and none may be extra; how many it saw
    is printed, and a window that saw fewer than half is profiled again,
    three times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    expected = n * per_call
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        events = [e for e in device if kernel_name in e.key]
        count = sum(e.count for e in events)
        print(f"profiler: {count} of {expected} launches of {kernel_name} recorded")
        if 0.5 * expected <= count <= expected:
            break
        if count > expected or attempt == 2:
            raise RuntimeError(f"profiler saw {count} launches of {kernel_name}, expected {expected}")
    return {
        "kernel_ms": sum(e.self_device_time_total for e in events) / count / 1e3,
        "launches_seen": count,
        "launches_expected": expected,
        "kernels_per_call": sum(e.count for e in device) / n,
        "device_ms_per_call": sum(e.self_device_time_total for e in device) / n / 1e3,
    }


def device_ms_per_call(fn, n: int, kernel_name: str, torch) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel_name``, from torch.profiler over ``n`` calls of ``fn`` (one
    launch each; see :func:`profile_calls`)."""
    return profile_calls(fn, n, kernel_name, torch)["kernel_ms"]


def graph_device_ms(fn, n: int, torch) -> float:
    """Milliseconds per call of ``fn`` on the device alone: ``n`` calls
    captured in one CUDA graph, one replay timed with CUDA events. Back-to-
    back wrapper calls (:func:`time_ms`) measure the host's enqueue rate
    whenever the wrapper is slower than its kernel; the replay launches
    the captured kernels with no host in between."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_times(fn, kernel_name: str, torch, per_call: int = 1, n_wrapper: int = 500,
                 n_profile: int = 100, n_graph: int = 100) -> dict:
    """A kernel's call timed three ways: the wrapper by CUDA events over
    back-to-back calls, the kernel by torch.profiler, and the call's
    device work in a CUDA graph."""
    prof = profile_calls(fn, n_profile, kernel_name, torch, per_call)
    return {
        "wrapper_ms": time_ms(fn, n_wrapper, torch),
        "kernel_device_ms": prof["kernel_ms"],
        "graph_ms": graph_device_ms(fn, n_graph, torch),
        "device_kernels_per_call": prof["kernels_per_call"],
        "device_ms_per_call": prof["device_ms_per_call"],
        "profiler_launches": [prof["launches_seen"], prof["launches_expected"]],
    }


def floor_kernel_times(torch) -> dict:
    """The shortest kernel the card runs, a floor for the microsecond-scale
    kernels: PyTorch's add of 1 to a one-element tensor, timed by the
    profiler and in a CUDA graph (it is measured here, not used)."""
    x = torch.zeros(1, device="cuda")
    prof = profile_calls(lambda: x.add_(1.0), 100, "elementwise_kernel", torch)
    out = {"kernel_device_ms": prof["kernel_ms"],
           "graph_ms": graph_device_ms(lambda: x.add_(1.0), 100, torch)}
    print(f"floor: a one-element add, {1e3 * out['kernel_device_ms']:.3f} us per launch "
          f"(profiler), {1e3 * out['graph_ms']:.3f} us (CUDA graph)")
    return out


def gae_inputs(T: int, B: int, seed: int, device, torch, flag_dtype=None):
    """rewards, values, last value and the done / truncation flags of one
    key (float32 flags, or ``flag_dtype``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    done = rng.rand(T, B) < 0.1
    truncated = done & (rng.rand(T, B) < 0.5)
    arrays = (
        rng.randn(T, B).astype(np.float32),
        rng.randn(T, B).astype(np.float32),
        rng.randn(B).astype(np.float32),
        done.astype(np.float32),
        truncated.astype(np.float32),
    )
    out = [torch.tensor(a, device=device) for a in arrays]
    if flag_dtype is not None:
        out[3:] = [x.to(flag_dtype) for x in out[3:]]
    return out


# One minibatch of GAE on each path: (T, B, reward keys). The flags come
# as the rollout stores them, bool, one tensor shared by the keys.
GAE_PATH_SHAPES = {"flagship": (30, 256, 1), "quadruped": (20, 512, 2)}
# Columns (threads) per block of the GAE kernel that the run compares.
GAE_COLUMN_VARIANTS = (16, 32, 64, 128)


def gae_path_inputs(T: int, B: int, n_keys: int, torch, per_key_flags: bool = False) -> tuple:
    """(rewards, values, last values, done, truncation) of one minibatch:
    dicts per reward key (a tensor for one key) and one pair of bool flags
    shared by the keys (or a pair per key)."""
    keys = [f"key{k}" for k in range(n_keys)]
    per_key = {k: gae_inputs(T, B, seed=i, device="cuda", torch=torch, flag_dtype=torch.bool)
               for i, k in enumerate(keys)}
    tree = [{k: per_key[k][j] for k in keys} for j in range(5)]
    if not per_key_flags:
        tree[3], tree[4] = per_key[keys[0]][3], per_key[keys[0]][4]
    if n_keys == 1:
        tree = [x[keys[0]] if isinstance(x, dict) else x for x in tree]
    return tuple(tree)


def gae_keys(inputs: tuple) -> dict:
    """Key -> (rewards, values, last value, done, truncation) of
    :func:`gae_path_inputs`' tuple."""
    if not isinstance(inputs[0], dict):
        return {"key0": inputs}
    return {k: tuple(x[k] if isinstance(x, dict) else x for x in inputs) for k in inputs[0]}


def gae_call(inputs: tuple, lam: float, gamma: float):
    """One minibatch's GAE as ppo_loss runs it: gae_per_key (one launch for
    all keys) where the package has it, else one gae_cuda call per key."""
    from nnx_ppo_tpu_torch.ops import gae as gae_module

    if hasattr(gae_module, "gae_per_key"):
        return lambda: gae_module.gae_per_key(*inputs, lam, gamma)
    rewards, values, last, done, truncation = inputs
    if not isinstance(rewards, dict):
        return lambda: gae_module.gae_cuda(rewards, values, last, done, truncation, lam, gamma)
    keys = list(rewards)
    return lambda: {k: gae_module.gae_cuda(rewards[k], values[k], last[k], done, truncation,
                                           lam, gamma) for k in keys}


def gae_bound_ms(T: int, B: int, n_keys: int, flag_bytes: int = 1) -> tuple[float, str]:
    """Bytes per key: rewards, values and the output as float32, the two
    flags at ``flag_bytes`` each, last value; some 10 operations a step."""
    n_bytes = n_keys * ((12 + 2 * flag_bytes) * T * B + 4 * B)
    return bound_ms(n_bytes, 10 * T * B * n_keys)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 peak."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def gae_kernel_phase(torch) -> dict:
    from nnx_ppo_tpu_torch.ops import gae as gae_module
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda, gae_per_key, gae_scan

    lam, gamma = 0.95, 0.99
    max_err = 0.0
    # One key through gae_cuda, float flags.
    for i, (T, B) in enumerate([(30, 256), (20, 512), (30, 1024), (7, 1000)]):
        args = gae_inputs(T, B, seed=i, device="cuda", torch=torch)
        check(bool(args[3].any() and args[4].any()), "done and truncation flags are set")
        got = gae_cuda(*args, lam, gamma)
        want = gae_scan(*args, lam, gamma)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        check(bool(torch.equal(got, want)), f"gae [{T}, {B}] equals gae_scan to the bit")
        print(f"gae [{T}, {B}]: max_abs_err {err:.3g}; torch.equal True")
    # Every key in one launch, bool flags: the paths' minibatches and a
    # ragged batch with three keys and per-key flags.
    for T, B, n_keys, per_key_flags in ((30, 256, 1, False), (20, 512, 2, False), (7, 33, 3, True)):
        inputs = gae_path_inputs(T, B, n_keys, torch, per_key_flags)
        before = gae_cuda.launches
        got = gae_per_key(*inputs, lam, gamma)
        check(gae_cuda.launches == before + 1, f"gae_per_key [{T}, {B}] x {n_keys}: one launch")
        got = got if isinstance(got, dict) else {"key0": got}
        for k, key in gae_keys(inputs).items():
            want = gae_scan(*key, lam, gamma)
            max_err = max(max_err, (got[k] - want).abs().max().item())
            check(bool(torch.equal(got[k], want)),
                  f"gae_per_key [{T}, {B}] {k} equals gae_scan to the bit")
        print(f"gae_per_key [{T}, {B}] x {n_keys} keys, bool flags"
              f"{' per key' if per_key_flags else ' shared'}: one launch, every key torch.equal True")

    # Columns per block: each variant equal to the bit, then timed in a
    # CUDA graph at both path shapes, in one order and then the reverse.
    shipped_columns = gae_module.GAE_COLUMNS
    shapes = {label: gae_path_inputs(*shape, torch) for label, shape in GAE_PATH_SHAPES.items()}
    columns_ms: dict = {c: {label: [] for label in shapes} for c in GAE_COLUMN_VARIANTS}
    try:
        for order in (GAE_COLUMN_VARIANTS, GAE_COLUMN_VARIANTS[::-1]):
            for columns in order:
                gae_module.GAE_COLUMNS = columns
                for label, inputs in shapes.items():
                    got = gae_per_key(*inputs, lam, gamma)
                    gae_module.GAE_COLUMNS = shipped_columns
                    want = gae_per_key(*inputs, lam, gamma)
                    gae_module.GAE_COLUMNS = columns
                    same = [torch.equal(got[k], want[k]) for k in got] if isinstance(got, dict) \
                        else [torch.equal(got, want)]
                    check(all(same), f"gae {columns} columns per block: the same bits")
                    columns_ms[columns][label].append(
                        graph_device_ms(gae_call(inputs, lam, gamma), 100, torch))
    finally:
        gae_module.GAE_COLUMNS = shipped_columns
    for columns, by_label in columns_ms.items():
        print(f"gae variant {columns} columns per block: " + ", ".join(
            f"{label} " + " / ".join(f"{1e3 * t:.3f}" for t in ts) + " us (graph)"
            for label, ts in by_label.items()))

    timed = {}
    for label, (T, B, n_keys) in GAE_PATH_SHAPES.items():
        inputs = shapes[label]
        times = kernel_times(gae_call(inputs, lam, gamma), "gae_kernel", torch)
        keys = list(gae_keys(inputs).values())
        times["plain_ms"] = time_ms(lambda: [gae_scan(*key, lam, gamma) for key in keys], 20, torch)
        times["bound_ms"], times["bound_by"] = gae_bound_ms(T, B, n_keys)
        times["shape"] = [T, B, n_keys]
        timed[label] = times
        print(f"gae [{T}, {B}] x {n_keys} key(s) in one launch: wrapper {1e3 * times['wrapper_ms']:.2f} "
              f"us, kernel {1e3 * times['kernel_device_ms']:.3f} us (profiler), "
              f"{1e3 * times['graph_ms']:.3f} us (CUDA graph), "
              f"{times['device_kernels_per_call']:.1f} device kernels per call, bound "
              f"{1e3 * times['bound_ms']:.4f} us ({times['bound_by']})")
    flagship_shape, quadruped_shape = timed["flagship"], timed["quadruped"]
    floor = floor_kernel_times(torch)
    return {
        "name": "gae",
        "route": "cuda",
        "source": "nnx_ppo_tpu_torch/csrc/gae.cu",
        "replaces": "nnx_ppo_tpu/ops/gae.py:105",
        "launches": None,
        "max_abs_err": max_err,
        "ms": flagship_shape["wrapper_ms"],
        "plain_ms": flagship_shape["plain_ms"],
        "bound_ms": flagship_shape["bound_ms"],
        "bound_by": flagship_shape["bound_by"],
        "library_ms": None,  # no single PyTorch call computes GAE
        "shape": flagship_shape["shape"],
        "kernel_device_ms": flagship_shape["kernel_device_ms"],
        "graph_ms": flagship_shape["graph_ms"],
        "at_20x512x2": quadruped_shape,
        "floor_kernel": floor,
        "columns_graph_ms": {str(c): v for c, v in columns_ms.items()},
        "design": (f"one launch for every reward key (blockIdx.y), {shipped_columns} columns per "
                   "block, [T, columns] tiles staged by cp.async before the recurrence, flags read "
                   "as bool or float32"),
        "ptxas": ptxas_row(("gae", ()), "gae_kernelIhh"),
    }


DR_RANGES = dict(
    mass_scale=(0.8, 1.2), friction=(0.4, 1.0), damping_scale=(0.9, 1.1), gain_scale=(0.9, 1.1)
)
ROUGH = dict(seed=2, amplitude=0.03, wavelength=1.5)

# The control-step configurations checked against the plain version:
# name -> (batch, exact, full feature set). 33 and 1001 end inside a warp
# at every group size from 2 to 16 lanes per env.
CONTROL_STEP_CASES = {
    "held, full features, B=2048": (2048, False, True),
    "exact, full features, B=2048": (2048, True, True),
    "held, flat ground, no extras, B=1000": (1000, False, False),
    "held, full features, B=33": (33, False, True),
    "exact, full features, B=1001": (1001, True, True),
}
# The (lanes per env, threads per block) variants of --variants.
CONTROL_STEP_GROUPS, SCENE_STEP_GROUPS = (2, 4, 8, 16), (1, 2, 4, 8)
VARIANT_THREADS = (32, 64, 128, 256)
# Dynamic shared memory a block of the H100 can have.
MAX_BLOCK_SMEM_BYTES = 232448


def control_step_case(name: str, torch):
    """(plan, args on the card) of one control-step configuration: the
    quadruped at kp=60, 10 substeps of 2 ms, states near the standing
    pose with some feet in contact."""
    from nnx_ppo_tpu_torch.physics.cuda_step import ControlStepPlan
    from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
    from nnx_ppo_tpu_torch.physics.terrain import rough_terrain
    from nnx_ppo_tpu_torch.physics.testing import standing_states

    B, exact, full = CONTROL_STEP_CASES[name]
    model = make_quadruped()
    terrain = rough_terrain(**ROUGH) if full else None
    plan = ControlStepPlan(
        model, 60.0, 0.002, 10, exact, terrain=terrain,
        dr_fields=tuple(DR_RANGES) if full else (), has_push=full,
    )
    arrays = standing_states(
        model, default_qpos(model), B, seed=3, terrain=terrain,
        n_extra_dr=4 if full else 0, has_push=full,
    )
    keys = ("qpos", "qvel", "target") + (("extra",) if full else ())
    return plan, [torch.tensor(arrays[k], device="cuda") for k in keys]


OUTPUTS = ("qpos", "qvel", "normals")


def equal_to_the_bit(got, want, torch) -> dict:
    """torch.equal of each output with the plain version's."""
    return {k: bool(torch.equal(g, w)) for k, g, w in zip(OUTPUTS, got, want)}


def describe_equal(equal: dict) -> str:
    return "torch.equal " + " ".join(f"{k} {v}" for k, v in equal.items())


def control_step_errors(plan, args, torch) -> tuple[dict, dict]:
    """Kernel against plain version on the card, at the stated tolerance:
    float32 on both; ten substeps; qpos 2e-4, qvel 2e-3, normals rtol
    5e-3 / atol 5e-2 (the contact switch phi > 0 and the 6000 N/m contact
    stiffness amplify rounding). Also whether each output is equal to the
    bit (the kernel repeats the plain version's operations in its order)."""
    got = plan.cuda(*args)
    want = plan.plain(*args)
    torch.cuda.synchronize()
    check(bool((want[2] > 0).any() and (want[2] == 0).any()), "some feet touch, some do not")
    for x in got:
        check(bool(torch.isfinite(x).all()), "kernel output is finite")
    errs = {k: (g - w).abs().max().item() for k, g, w in zip(OUTPUTS, got, want)}
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-4)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=2e-3)
    torch.testing.assert_close(got[2], want[2], rtol=5e-3, atol=5e-2)
    return errs, equal_to_the_bit(got, want, torch)


def launch_design(plan) -> str:
    """A lane-group kernel's launch, as the kernels line reports it."""
    per_block = plan.threads_per_block // plan.group_size
    return (f"lane group G={plan.group_size}, {plan.threads_per_block} threads per block "
            f"({per_block} envs and {plan.shared_memory_bytes()} B of dynamic shared memory "
            "per block)")


def ptxas_row(spec, kernel: str, dynamic_smem_bytes: int = 0) -> dict:
    """What ptxas reported of ``kernel`` when its library was built, and
    the dynamic shared memory of its launch."""
    from nnx_ppo_tpu_torch.ops import cuda_build

    return dict(cuda_build.ptxas_info(spec[0], spec[1], kernel),
                dynamic_smem_bytes=dynamic_smem_bytes)


def sweep_variants(label: str, make_plan, args, groups, torch) -> dict:
    """Each (lanes per env, threads per block) variant of a lane-group
    kernel at one shape: built (all at once), checked equal to the bit with
    the plain version, and timed with CUDA events twice, in one order and
    then in the reverse one. Variants whose envs do not fit a block's
    shared memory are listed and skipped."""
    from nnx_ppo_tpu_torch.ops import cuda_build

    plans = {}
    for group in groups:
        for threads in VARIANT_THREADS:
            plan = make_plan()
            plan.group_size, plan.threads_per_block = group, threads
            plans[(group, threads)] = plan
    cuda_build.build(sorted({plan.kernel_spec for plan in plans.values()}))
    want = next(iter(plans.values())).plain(*args)
    rows = {}
    for key, plan in plans.items():
        smem = plan.shared_memory_bytes()
        rows[key] = {"group": key[0], "threads": key[1], "smem_bytes": smem,
                     "fits": smem <= MAX_BLOCK_SMEM_BYTES, "ms": []}
        if rows[key]["fits"]:
            got = plan.cuda(*args)
            torch.cuda.synchronize()
            rows[key]["equal"] = all(equal_to_the_bit(got, want, torch).values())
    order = [key for key, row in rows.items() if row["fits"]]
    for key in order + order[::-1]:
        rows[key]["ms"].append(time_ms(lambda: plans[key].cuda(*args), 30, torch))
    fastest = min(order, key=lambda key: sum(rows[key]["ms"]))
    for key, row in rows.items():
        timing = (", ".join(f"{t:.4f}" for t in row["ms"]) + " ms, torch.equal "
                  f"{row['equal']}") if row["fits"] else "does not fit a block"
        print(f"{label} variant G={key[0]}, {key[1]} threads per block, {row['smem_bytes']} B "
              f"shared per block: {timing}")
    shipped = make_plan()
    print(f"{label}: fastest G={fastest[0]}, {fastest[1]} threads per block; shipped "
          f"G={shipped.group_size}, {shipped.threads_per_block}")
    check(all(row["equal"] for row in rows.values() if row["fits"]),
          f"{label}: every variant equals the plain version to the bit")
    return {"rows": list(rows.values()), "fastest": list(fastest),
            "shipped": [shipped.group_size, shipped.threads_per_block]}


def count_plain_operations(plain_fn, args, torch) -> float:
    """Float operations per env of one call of a plain version on 8 envs:
    every elementwise arithmetic op it runs counts one operation per
    output element (sin, cos, sqrt, sinc, floor and division count one
    each)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arithmetic = {
        "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "sin", "cos", "sinc", "pow",
        "clamp", "clamp_min", "clamp_max", "where", "gt", "ge", "le", "reciprocal", "floor",
    }
    counted = {"ops": 0}

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in arithmetic and torch.is_tensor(out):
                counted["ops"] += out.numel()
            return out

    small = [a[:8] for a in args]
    with Counter():
        plain_fn(*small)
    return counted["ops"] / 8


def control_step_kernel_phase(torch, variants: bool) -> dict:
    from nnx_ppo_tpu_torch.ops import cuda_build
    from nnx_ppo_tpu_torch.physics import cuda_step

    max_err = 0.0
    cases = {}
    for name in CONTROL_STEP_CASES:
        plan, args = control_step_case(name, torch)
        before = cuda_step.control_step_cuda.launches
        errs, equal = control_step_errors(plan, args, torch)
        check(cuda_step.control_step_cuda.launches == before + 1, "the wrapper counted its launch")
        max_err = max(max_err, errs["qpos"], errs["qvel"])
        cases[name] = (plan, args)
        print(f"control_step {name}: max_abs_err qpos {errs['qpos']:.3g} (atol 2e-4) "
              f"qvel {errs['qvel']:.3g} (atol 2e-3) normals {errs['normals']:.3g} "
              f"(rtol 5e-3, atol 5e-2); {describe_equal(equal)}")

    # The physics leg's shape: 2048 envs, all feature lanes, held factor.
    plan, args = cases["held, full features, B=2048"]
    model = plan.model
    ms = time_ms(lambda: plan.cuda(*args), 50, torch)
    kernel_device_ms = device_ms_per_call(lambda: plan.cuda(*args), 20, "control_step_kernel", torch)
    plain_ms = time_ms(lambda: plan.plain(*args), 2, torch)
    exact_plan, exact_args = cases["exact, full features, B=2048"]
    exact_ms = time_ms(lambda: exact_plan.cuda(*exact_args), 20, torch)
    B = args[0].shape[0]
    bytes_per_env = 4 * (model.nq + model.nv + model.nj + plan.n_extra
                         + model.nq + model.nv + plan.n_geoms)
    ops_per_env = count_plain_operations(plan.plain, args, torch)
    bound, bound_by = bound_ms(bytes_per_env * B, ops_per_env * B)
    print(f"control_step: {bytes_per_env} bytes and {ops_per_env:.0f} float operations per env "
          f"and control step; exact-mode kernel {exact_ms:.4f} ms")
    result = {
        "name": "control_step",
        "route": "cuda",
        "source": "nnx_ppo_tpu_torch/csrc/control_step.cu",
        "replaces": "nnx_ppo_tpu/physics/pallas_step.py:330",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes a control step
        "shape": [B, model.nq],
        "kernel_device_ms": kernel_device_ms,
        "exact_ms": exact_ms,
        "ops_per_env": ops_per_env,
        "bytes_per_env": bytes_per_env,
        "design": launch_design(plan),
        "ptxas": ptxas_row(plan.kernel_spec, "control_step_kernel", plan.shared_memory_bytes()),
    }
    if variants:
        # The same source with fused multiply-adds left on (nvcc's
        # default), beside the shipped build, inside this one run.
        shipped = cuda_step.KERNEL_FLAGS
        try:
            cuda_step.KERNEL_FLAGS = tuple(f for f in shipped if f != "-fmad=false")
            fma_plan, _ = control_step_case("held, full features, B=2048", torch)
            cuda_build.build([fma_plan.kernel_spec])
            got, want = fma_plan.cuda(*args), plan.plain(*args)
            errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
            fma_ms = time_ms(lambda: fma_plan.cuda(*args), 50, torch)
        finally:
            cuda_step.KERNEL_FLAGS = shipped
        again_ms = time_ms(lambda: plan.cuda(*args), 50, torch)
        print(f"control_step with fused multiply-adds: max_abs_err qpos {errs[0]:.3g} qvel "
              f"{errs[1]:.3g} normals {errs[2]:.3g}; {fma_ms:.4f} ms against {again_ms:.4f} ms "
              "without (shipped)")
        result["fma"] = {"qpos": errs[0], "qvel": errs[1], "normals": errs[2], "ms": fma_ms,
                         "shipped_ms": again_ms}
        result["variants"] = sweep_variants(
            "control_step", lambda: control_step_case("held, full features, B=2048", torch)[0],
            args, CONTROL_STEP_GROUPS, torch,
        )
    return result


PHASE_CLOCKS = r"""
// Instrumented copy (chip_smoke.py --phases): cycles between the barriers
// of block 0's thread 0, summed over the launches since the last reset.
__device__ unsigned long long cs_phase_cycles[128];
__device__ long long cs_phase_last;
#define CS_PHASE_START() do { if (blockIdx.x == 0 && threadIdx.x == 0) cs_phase_last = clock64(); } while (0)
#define CS_PHASE_MARK(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
  const long long t_ = clock64(); cs_phase_cycles[k] += t_ - cs_phase_last; cs_phase_last = t_; } } while (0)
"""
PHASE_READER = r"""
extern "C" int phase_cycles(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, cs_phase_cycles, sizeof(cs_phase_cycles));
  static const unsigned long long zeros[128] = {};
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyToSymbol(cs_phase_cycles, zeros, sizeof(zeros)));
}
"""
# Where each kernel starts its clock: (source, the statement after which).
PHASE_STARTS = {"control_step.cu": "Env& s = env_in_shared(envs);",
                "scene_step.cu": "envs + static_cast<int>(threadIdx.x / SS_G) * kSceneEnvWords);"}


def instrumented_sources(root: str) -> list[tuple[int, str]]:
    """Copies of csrc/ under ``root`` with a clock mark after every lane-
    group barrier; returns each mark's (id, "file:line label")."""
    from nnx_ppo_tpu_torch.ops import cuda_build

    if os.path.isdir(root):
        shutil.rmtree(root)
    shutil.copytree(cuda_build.CSRC_DIR, root)
    labels = []
    for name in ("spatial_math.cuh", "rigid_body.cuh", "control_step.cu", "scene_step.cu"):
        path = os.path.join(root, name)
        lines = open(path).read().split("\n")
        label = ""
        for n, line in enumerate(lines):
            comment = re.match(r"\s*//\s*(.*)", line)
            if comment and comment.group(1).strip("- "):
                label = comment.group(1).strip("- ")
            if re.search(r"\bg\.sync\(\);", line) and "void sync" not in line:
                labels.append((len(labels), f"{name}:{n + 1} {label}"))
                lines[n] = line.replace("g.sync();", f"g.sync(); CS_PHASE_MARK({labels[-1][0]});")
            if name in PHASE_STARTS and PHASE_STARTS[name] in line:
                lines[n] = line + " CS_PHASE_START();"
        text = "\n".join(lines)
        if name == "spatial_math.cuh":
            text = text.replace("#include <math.h>", "#include <math.h>\n" + PHASE_CLOCKS)
        if name.endswith(".cu"):
            text += PHASE_READER
        open(path, "w").write(text)
    check(len(labels) < 128, "fewer than 128 marks")
    return labels


def phases_phase(torch) -> dict:
    """Cycles of each phase of one launch, first env, at the physics leg's
    control step (held factor, B=2048) and the pusher's and reacher's scene
    step (B=4096), from the instrumented copies."""
    import ctypes

    from nnx_ppo_tpu_torch.ops import cuda_build

    root = os.path.join(os.path.dirname(str(cuda_build.BUILD_DIR)), "phase_csrc")
    labels = dict(instrumented_sources(root))
    shipped_dir, shipped_libraries = cuda_build.CSRC_DIR, dict(cuda_build._LOADED)
    out = {}
    try:
        # The loader caches libraries by name and flags: load the copies.
        cuda_build.CSRC_DIR = type(shipped_dir)(root)
        cuda_build._LOADED.clear()
        cases = {
            "control_step": control_step_case("held, full features, B=2048", torch),
            "scene_step pusher": scene_step_case("pusher, B=4096", torch),
            "scene_step reacher": scene_step_case("reacher, B=4096", torch),
        }
        cuda_build.build([plan.kernel_spec for plan, _ in cases.values()])
        for label, (plan, args) in cases.items():
            lib = cuda_build.load(*plan.kernel_spec)
            read = lib.phase_cycles
            read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
            cycles = (ctypes.c_ulonglong * 128)()
            plan.cuda(*args)
            torch.cuda.synchronize()
            check(read(cycles) == 0, "read the phase clocks")  # and reset them
            plan.cuda(*args)
            torch.cuda.synchronize()
            check(read(cycles) == 0, "read the phase clocks")
            total = sum(cycles)
            rows = sorted(((int(c), labels[k]) for k, c in enumerate(cycles) if c), reverse=True)
            out[label] = {"total_cycles": total, "phases": [[c, where] for c, where in rows]}
            print(f"phases {label}: {total} cycles of the first env's lanes in one launch")
            for c, where in rows:
                print(f"phases {label}: {c:>9d} cycles, {c / total:.3f}: {where}")
    finally:
        cuda_build.CSRC_DIR = shipped_dir
        cuda_build._LOADED.clear()
        cuda_build._LOADED.update(shipped_libraries)
    return out


def data_terrain(n: int = 256, extent: float = 12.0):
    """The data-terrain path's HeightGrid: the rough terrain of the
    physics leg sampled onto an n x n table over [-extent, extent]^2."""
    from nnx_ppo_tpu_torch.physics.terrain import HeightGrid, rough_terrain

    return HeightGrid.sample(rough_terrain(**ROUGH), extent=extent, n=n)


# The sampler configurations checked against the plain version:
# name -> (batch, table points per side, table half-extent in metres). The
# envs stand within +-5 m, so some stand outside the small table; 33 ends
# inside a block at every launch of the sweep.
PLANE_SAMPLER_CASES = {
    "B=2048 on the 256x256 table": (2048, 256, 12.0),
    "B=1000 on a 32x32 table, some envs outside": (1000, 32, 3.0),
    "B=33 on the 256x256 table": (33, 256, 12.0),
}
# The (lanes per env, threads per block) variants of the plane sampler.
SAMPLER_GROUPS, SAMPLER_THREADS = (4, 8, 16), (64, 128, 256)


def plane_sampler_case(name: str, torch):
    """(plan, qpos on the card) of one sampler configuration: standing
    quadrupeds spread over the spawn radius, at the local ground height."""
    from nnx_ppo_tpu_torch.physics.cuda_step import ControlStepPlan
    from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
    from nnx_ppo_tpu_torch.physics.terrain import rough_terrain
    from nnx_ppo_tpu_torch.physics.testing import standing_states

    B, n, extent = PLANE_SAMPLER_CASES[name]
    model = make_quadruped()
    plan = ControlStepPlan(model, 60.0, 0.002, 10, terrain=data_terrain(n, extent))
    arrays = standing_states(model, default_qpos(model), B, seed=5, terrain=rough_terrain(**ROUGH))
    return plan, [torch.tensor(arrays[k], device="cuda") for k in ("qpos", "qvel", "target")]


def sampler_variant(plan, group: int, threads: int):
    """A plan on the same model and table whose sampler runs ``group`` lanes
    per env in blocks of ``threads``."""
    from nnx_ppo_tpu_torch.physics.cuda_step import ControlStepPlan

    variant = ControlStepPlan(plan.model, 60.0, 0.002, 10, terrain=plan.heightgrid)
    variant.sampler_group, variant.sampler_threads = group, threads
    return variant


def plane_sampler_kernel_phase(torch) -> dict:
    """The plane sampler against its plain version: the kernel repeats the
    plain version's float32 operations in its order, so every variant of
    the (lanes per env, threads per block) sweep must equal it to the bit
    on every case; then the variants timed in a CUDA graph at the
    data-terrain path's shape, in one order and then the reverse."""
    from nnx_ppo_tpu_torch.physics import cuda_step

    max_err = 0.0
    cases = {}
    for name in PLANE_SAMPLER_CASES:
        plan, args = plane_sampler_case(name, torch)
        qpos = args[0]
        before = cuda_step.plane_sampler_cuda.launches
        got = plan.sample_planes_cuda(qpos)
        check(cuda_step.plane_sampler_cuda.launches == before + 1, "the wrapper counted its launch")
        want = plan.sample_planes_plain(qpos)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "sampler output is finite")
        check(bool((want[:, 1::3].abs() > 1e-3).any()), "the ground slopes under some geoms")
        extent = PLANE_SAMPLER_CASES[name][2]
        outside = (qpos[:, :2].abs() > extent).any(dim=1)
        check(bool(outside.any()) == (extent < 5.0), "envs outside the table only on the small one")
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        check(bool(torch.equal(got, want)), f"plane_sampler {name} equals the plain version")
        cases[name] = (plan, qpos, want)
        print(f"plane_sampler {name}: max_abs_err {err:.3g}, torch.equal True, "
              f"{int(outside.sum())} envs outside")

    path_case = "B=2048 on the 256x256 table"
    plan, qpos, _ = cases[path_case]
    variants = {(g, t): {c: sampler_variant(cases[c][0], g, t) for c in cases}
                for g in SAMPLER_GROUPS for t in SAMPLER_THREADS}
    for (group, threads), plans in variants.items():
        for name, variant in plans.items():
            got = variant.sample_planes_cuda(cases[name][1])
            check(bool(torch.equal(got, cases[name][2])),
                  f"plane_sampler G={group}, {threads} threads, {name}: equal to the bit")
    sweep_ms: dict = {key: [] for key in variants}
    for order in (list(variants), list(variants)[::-1]):
        for key in order:
            variant = variants[key][path_case]
            sweep_ms[key].append(graph_device_ms(lambda: variant.sample_planes_cuda(qpos), 100, torch))
    fastest = min(sweep_ms, key=lambda key: sum(sweep_ms[key]))
    for (group, threads), ts in sweep_ms.items():
        smem = variants[(group, threads)][path_case].sampler_shared_memory_bytes()
        print(f"plane_sampler variant G={group}, {threads} threads per block, {smem} B shared per "
              f"block: " + " / ".join(f"{1e3 * t:.3f}" for t in ts) + " us (graph), torch.equal "
              "True on every case")
    print(f"plane_sampler: fastest G={fastest[0]}, {fastest[1]} threads per block; shipped "
          f"G={plan.sampler_group}, {plan.sampler_threads}")

    # The data-terrain path's shape, at the shipped launch.
    model, grid = plan.model, plan.heightgrid
    times = kernel_times(lambda: plan.sample_planes_cuda(qpos), "plane_sampler_kernel", torch,
                         n_wrapper=200, n_profile=50)
    plain_ms = time_ms(lambda: plan.sample_planes_plain(qpos), 5, torch)
    # Bytes: qpos in, planes out, and every table entry that this run's
    # geoms read, once.
    B = qpos.shape[0]
    geom_xy = sampled_geom_xy(plan, qpos, torch)
    nx, ny = grid.shape
    i = torch.clamp(torch.floor((geom_xy[..., 0] - grid.x0) / grid.dx), 0, nx - 2).long()
    j = torch.clamp(torch.floor((geom_xy[..., 1] - grid.y0) / grid.dy), 0, ny - 2).long()
    corners = torch.stack([i * ny + j, (i + 1) * ny + j, i * ny + j + 1, (i + 1) * ny + j + 1])
    table_bytes = 4 * int(torch.unique(corners).numel())
    n_bytes = 4 * B * (model.nq + 3 * len(model.geom_body)) + table_bytes
    ops_per_env = count_plain_operations(plan.sample_planes_plain, [qpos], torch)
    bound, bound_by = bound_ms(n_bytes, ops_per_env * B)
    print(f"plane_sampler: {n_bytes} bytes ({table_bytes} of the table) and {ops_per_env:.0f} "
          f"float operations per env; wrapper {1e3 * times['wrapper_ms']:.2f} us, kernel "
          f"{1e3 * times['kernel_device_ms']:.3f} us (profiler), {1e3 * times['graph_ms']:.3f} us "
          f"(CUDA graph), bound {1e3 * bound:.4f} us ({bound_by})")
    ptxas = {f"G={g}": ptxas_row(variants[(g, plan.sampler_threads)][path_case].sampler_spec,
                                 "plane_sampler_kernel",
                                 variants[(g, plan.sampler_threads)][path_case]
                                 .sampler_shared_memory_bytes())
             for g in SAMPLER_GROUPS}
    return {
        "name": "plane_sampler",
        "route": "cuda",
        "source": "nnx_ppo_tpu_torch/csrc/plane_sampler.cu",
        "replaces": "nnx_ppo_tpu/physics/pallas_step.py:212",
        "launches": None,
        "max_abs_err": max_err,
        "ms": times["wrapper_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call does FK and a bilinear tangent plane
        "shape": [B, model.nq],
        "kernel_device_ms": times["kernel_device_ms"],
        "graph_ms": times["graph_ms"],
        "profiler_launches": times["profiler_launches"],
        "ops_per_env": ops_per_env,
        "bytes": n_bytes,
        "sweep_graph_ms": {f"G={g},{t}": ms for (g, t), ms in sweep_ms.items()},
        "fastest": list(fastest),
        "design": (f"lane group G={plan.sampler_group}, {plan.sampler_threads} threads per block "
                   f"({plan.sampler_threads // plan.sampler_group} envs and "
                   f"{plan.sampler_shared_memory_bytes()} B of dynamic shared memory per block)"),
        "ptxas": ptxas[f"G={plan.sampler_group}"],
        "ptxas_by_group": ptxas,
    }


def sampled_geom_xy(plan, qpos, torch):
    """World xy of every ground geom, [B, n_geoms, 2], by the plain
    kinematics."""
    from nnx_ppo_tpu_torch.physics import soa
    from nnx_ppo_tpu_torch.physics.engine_soa import _kin_soa

    model = plan.model
    E, P, _, _, _ = _kin_soa(model, tuple(qpos.unbind(1)))
    xy = []
    for g, body in enumerate(model.geom_body):
        x_w = soa.v3_add(P[body], soa.m3_vec(E[body], tuple(float(v) for v in model.geom_offset[g])))
        xy.append(torch.stack([x_w[0], x_w[1]], dim=-1))
    return torch.stack(xy, dim=1)


def substeps_kernel_phase(torch, profile: bool) -> dict:
    """The substeps kernel against its plain version on the same factor
    (built outside, on the card): ten substeps in one launch and one per
    launch; tolerances as for the control step (0 is expected)."""
    from nnx_ppo_tpu_torch.physics import cuda_step
    from nnx_ppo_tpu_torch.physics.engine import mass_matrix_factor
    from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
    from nnx_ppo_tpu_torch.physics.testing import standing_states

    B, n_substeps = 2048, 10
    model = make_quadruped()
    arrays = standing_states(model, default_qpos(model), B, seed=3)
    args = [torch.tensor(arrays[k], device="cuda") for k in ("qpos", "qvel", "target")]
    chol = mass_matrix_factor(model, args[0], dt=0.002)
    args.append(chol)
    want = cuda_step.substeps_plain(model, *args, 60.0, 0.002, n_substeps)
    check(bool((want[2] > 0).any() and (want[2] == 0).any()), "some feet touch, some do not")
    max_err = 0.0
    runners = {}
    for per_kernel in (-1, 1):
        run = cuda_step.make_substep_runner(model, 60.0, 0.002, n_substeps, per_kernel)
        before = cuda_step.substeps_cuda.launches
        got = run(*args)
        torch.cuda.synchronize()
        n_launches = 1 if per_kernel == -1 else n_substeps
        check(cuda_step.substeps_cuda.launches == before + n_launches,
              "the wrapper counted its launches")
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-4)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=2e-3)
        torch.testing.assert_close(got[2], want[2], rtol=5e-3, atol=5e-2)
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        max_err = max(max_err, errs[0], errs[1])
        runners[per_kernel] = run
        print(f"substeps B={B}, {n_launches} launch(es) for {n_substeps} substeps: max_abs_err "
              f"qpos {errs[0]:.3g} (atol 2e-4) qvel {errs[1]:.3g} (atol 2e-3) normals "
              f"{errs[2]:.3g} (rtol 5e-3, atol 5e-2); "
              f"{describe_equal(equal_to_the_bit(got, want, torch))}")
    # A batch that ends inside a warp.
    ragged = standing_states(model, default_qpos(model), 33, seed=4)
    ragged_args = [torch.tensor(ragged[k], device="cuda") for k in ("qpos", "qvel", "target")]
    ragged_args.append(mass_matrix_factor(model, ragged_args[0], dt=0.002))
    got = runners[-1](*ragged_args)
    want_ragged = cuda_step.substeps_plain(model, *ragged_args, 60.0, 0.002, n_substeps)
    torch.cuda.synchronize()
    for g, w, atol, rtol in zip(got, want_ragged, (2e-4, 2e-3, 5e-2), (0, 0, 5e-3)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
    errs = [(g - w).abs().max().item() for g, w in zip(got, want_ragged)]
    max_err = max(max_err, errs[0], errs[1])
    print(f"substeps B=33, 1 launch for {n_substeps} substeps: max_abs_err qpos {errs[0]:.3g} "
          f"qvel {errs[1]:.3g} normals {errs[2]:.3g}; "
          f"{describe_equal(equal_to_the_bit(got, want_ragged, torch))}")

    # How far a control step with the outside factor lies from one with
    # the factor built inside the kernel (both kernels, same states).
    inside = cuda_step.ControlStepPlan(model, 60.0, 0.002, n_substeps).cuda(*args[:3])
    outside = runners[-1](*args)
    gap = [(a - b).abs().max().item() for a, b in zip(outside, inside)]
    print(f"substeps with the outside factor against the control step with the inside one: "
          f"qpos {gap[0]:.3g} qvel {gap[1]:.3g} normals {gap[2]:.3g}")

    all_in_one, one_each = runners[-1], runners[1]
    ms = time_ms(lambda: all_in_one(*args), 50, torch)
    kernel_device_ms = device_ms_per_call(lambda: all_in_one(*args), 20, "substeps_kernel", torch)
    one_each_ms = time_ms(lambda: one_each(*args), 20, torch)
    plain_ms = time_ms(
        lambda: cuda_step.substeps_plain(model, *args, 60.0, 0.002, n_substeps), 2, torch
    )
    # The factor build outside the kernel, which the path pays per env step.
    factor_ms = time_ms(lambda: mass_matrix_factor(model, args[0], dt=0.002), 5, torch)
    factor_kernels = None
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mass_matrix_factor(model, args[0], dt=0.002)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        factor_kernels = sum(e.count for e in events)
        factor_busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        print(f"profile mass_matrix_factor B={B}: {factor_kernels} device kernels, device busy "
              f"{factor_busy_ms:.3f} ms per call")
    nt = model.nv * (model.nv + 1) // 2
    bytes_per_env = 4 * (model.nq + model.nv + model.nj + nt
                         + model.nq + model.nv + len(model.geom_body) + len(model.pair_geom_a))
    plan = all_in_one.plan
    ops_per_env = count_plain_operations(plan.substeps_plain, args, torch)
    bound, bound_by = bound_ms(bytes_per_env * B, ops_per_env * B)
    print(f"substeps: {bytes_per_env} bytes and {ops_per_env:.0f} float operations per env and "
          f"{n_substeps} substeps; one launch per substep {one_each_ms:.4f} ms for all ten; "
          f"factor build outside {factor_ms:.3f} ms per call")
    return {
        "name": "substeps",
        "route": "cuda",
        "source": "nnx_ppo_tpu_torch/csrc/control_step.cu",
        "replaces": "nnx_ppo_tpu/physics/pallas_step.py:111",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes physics substeps
        "shape": [B, model.nq],
        "kernel_device_ms": kernel_device_ms,
        "one_launch_per_substep_ms": one_each_ms,
        "factor_build_ms": factor_ms,
        "factor_build_kernels": factor_kernels,
        "gap_to_inside_factor": {"qpos": gap[0], "qvel": gap[1], "normals": gap[2]},
        "ops_per_env": ops_per_env,
        "bytes_per_env": bytes_per_env,
        "design": launch_design(plan),
        "ptxas": ptxas_row(plan.kernel_spec, "substeps_kernel", plan.shared_memory_bytes()),
    }


# The scene control-step configurations checked against the plain version:
# name -> (scene, batch). "trees" is the five-body tree with every joint
# type and a pair inside it, beside a slider tree, with two cross pairs.
SCENE_STEP_CASES = {
    "pusher, B=4096": ("pusher", 4096),
    "reacher, B=4096": ("reacher", 4096),
    "pusher, B=1000": ("pusher", 1000),
    "pusher, B=33": ("pusher", 33),
    "general and slider trees, B=1001": ("trees", 1001),
}


def scene_step_case(name: str, torch):
    """(plan, args on the card) of one scene configuration: the runner of
    the env itself (pusher: arm + ball + cross pair, 16 substeps of 1.25
    ms; reacher: the arm alone, 4 substeps of 5 ms), or the two test trees
    (3 substeps of 2 ms), on seeded states."""
    import numpy as np

    from nnx_ppo_tpu_torch.envs import ArmPush, ArmReacher
    from nnx_ppo_tpu_torch.envs.pusher import SHOULDER_HEIGHT
    from nnx_ppo_tpu_torch.physics.cuda_scene_step import make_scene_control_step_runner
    from nnx_ppo_tpu_torch.physics.testing import (
        general_tree, general_tree_states, manipulation_states, slider_tree, slider_tree_states,
    )

    kind, B = SCENE_STEP_CASES[name]
    if kind == "pusher":
        plan = ArmPush()._scene_runner
        arrays = manipulation_states(B, seed=7, with_ball=True, shoulder_height=SHOULDER_HEIGHT)
    elif kind == "reacher":
        plan = ArmReacher()._scene_runner
        arrays = manipulation_states(B, seed=8, with_ball=False)
    else:
        plan = make_scene_control_step_runner(
            (general_tree(), slider_tree()), ((0, 0, 1, 0), (1, 1, 0, 2)), 0.002, 3
        )
        parts = [general_tree_states(B, seed=1), slider_tree_states(B, seed=2)]
        arrays = {k: np.concatenate([p[k] for p in parts], axis=1) for k in ("qpos", "qvel", "tau")}
    return plan, [torch.tensor(arrays[k], device="cuda") for k in ("qpos", "qvel", "tau")]


def scene_step_kernel_phase(torch, variants: bool) -> dict:
    """The scene kernel against its plain version on the card. The kernel
    repeats the plain version's float32 operations in its order, so 0 is
    expected; the stated tolerances are those the JAX package holds its
    lane code to against its generic engine: qpos 2e-5, qvel 5e-4,
    normals 1e-4 (rtol = atol)."""
    from nnx_ppo_tpu_torch.physics.cuda_scene_step import scene_step_cuda

    max_err = 0.0
    cases = {}
    for name in SCENE_STEP_CASES:
        plan, args = scene_step_case(name, torch)
        before = scene_step_cuda.launches
        got = plan.cuda(*args)
        check(scene_step_cuda.launches == before + 1, "the wrapper counted its launch")
        want = plan.plain(*args)
        torch.cuda.synchronize()
        for x in got:
            check(bool(torch.isfinite(x).all()), "kernel output is finite")
        check(got[2].shape == (args[0].shape[0], plan.n_normals), "normals shape")
        kind, B = SCENE_STEP_CASES[name]
        if kind == "pusher" and B >= 1000:
            # Columns: arm tip on the ground, ball on the ground, cross pair.
            check(bool((want[2] > 0).any(dim=0).all() and (want[2] == 0).any(dim=0).all()),
                  "each contact fires in some envs and not in others")
        if kind == "trees":
            check(bool((want[2] > 0).any() and (want[2] == 0).any()), "some contacts fire")
        errs = {k: (g - w).abs().max().item() for k, g, w in zip(OUTPUTS, got, want)}
        torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(got[1], want[1], rtol=5e-4, atol=5e-4)
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
        max_err = max(max_err, *errs.values())
        cases[name] = (plan, args)
        print(f"scene_step {name}, {plan.n_substeps} substeps: max_abs_err qpos {errs['qpos']:.3g} "
              f"(2e-5) qvel {errs['qvel']:.3g} (5e-4) normals {errs['normals']:.3g} (1e-4), "
              f"normals max {want[2].max().item():.3g}; "
              f"{describe_equal(equal_to_the_bit(got, want, torch))}")

    timed = {}
    for name in ("pusher, B=4096", "reacher, B=4096"):
        plan, args = cases[name]
        B = args[0].shape[0]
        bytes_per_env = 4 * (2 * plan.nq + 3 * plan.nv + plan.n_normals)
        ops_per_env = count_plain_operations(plan.plain, args, torch)
        bound, bound_by = bound_ms(bytes_per_env * B, ops_per_env * B)
        timed[name] = {
            "ms": time_ms(lambda: plan.cuda(*args), 50, torch),
            "kernel_device_ms": device_ms_per_call(
                lambda: plan.cuda(*args), 20, "scene_step_kernel", torch
            ),
            "plain_ms": time_ms(lambda: plan.plain(*args), 1, torch),
            "bound_ms": bound,
            "bound_by": bound_by,
            "ops_per_env": ops_per_env,
            "bytes_per_env": bytes_per_env,
            "shape": [B, plan.nq],
            "n_substeps": plan.n_substeps,
            "design": launch_design(plan),
            "ptxas": ptxas_row(plan.kernel_spec, "scene_step_kernel", plan.shared_memory_bytes()),
        }
        print(f"scene_step {name}: {bytes_per_env} bytes and {ops_per_env:.0f} float operations "
              f"per env and control step of {plan.n_substeps} substeps")
    pusher = timed["pusher, B=4096"]
    result = {
        "name": "scene_step",
        "route": "cuda",
        "source": "nnx_ppo_tpu_torch/csrc/scene_step.cu",
        "replaces": "nnx_ppo_tpu/physics/pallas_step.py:794",
        "launches": None,
        "max_abs_err": max_err,
        "ms": pusher["ms"],
        "plain_ms": pusher["plain_ms"],
        "bound_ms": pusher["bound_ms"],
        "bound_by": pusher["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a scene control step
        "shape": pusher["shape"],
        "kernel_device_ms": pusher["kernel_device_ms"],
        "ops_per_env": pusher["ops_per_env"],
        "bytes_per_env": pusher["bytes_per_env"],
        "design": pusher["design"],
        "ptxas": pusher["ptxas"],
        "at_reacher_4096": timed["reacher, B=4096"],
    }
    if variants:
        result["variants"] = {
            label: sweep_variants(f"scene_step {label}", lambda n=name: scene_step_case(n, torch)[0],
                                  cases[name][1], SCENE_STEP_GROUPS, torch)
            for label, name in (("pusher", "pusher, B=4096"), ("reacher", "reacher, B=4096"))
        }
    return result


def flagship(torch):
    from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
    from nnx_ppo_tpu_torch.envs import CartpoleBalance
    from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    env = EpisodeWrapper(CartpoleBalance(), max_len=500)
    networks = make_mlp_actor_critic(
        env.observation_size, env.action_size, [64] * 4, [256] * 2, 0,
        normalize_obs=True, entropy_weight=1e-3,
    )
    config = PPOConfig(
        n_envs=1024, rollout_length=30, n_epochs=4, n_minibatches=4, learning_rate=3e-4
    )
    return env, networks, config, make_optimizer(config.learning_rate)


def quadruped_leg(torch, legged):
    """A quadruped training leg around ``legged``: 500-step time limit, the
    Concat/Parallel actor-critic of the physics leg, its config and
    optimizer."""
    from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
    from nnx_ppo_tpu_torch.networks import (
        Concat, Dense, NormalTanhSampler, Parallel, PPOAdapter, Sequential, make_mlp,
    )
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    env = EpisodeWrapper(legged, max_len=500)
    proprio = env.observation_size["proprio"]
    n_act = env.action_size
    g = torch.Generator().manual_seed(0)
    enc = Concat.create(
        proprio=Dense.create(proprio, 128, g, torch.relu),
        command=Dense.create(3, 32, g, torch.relu),
    )
    actor = Sequential.create([
        Dense.create(160, 128, g, torch.relu),
        Dense.create(128, 2 * n_act, g),
        NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    critic = Parallel.create(
        tracking=make_mlp([160, 128, 1], g, activation_last_layer=False),
        penalty=make_mlp([160, 128, 1], g, activation_last_layer=False),
    )
    networks = Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])
    config = PPOConfig(n_envs=2048, rollout_length=20, combine_advantages=True)
    return env, networks, config, make_optimizer(config.learning_rate)


def physics_leg(torch):
    """The physics leg: env, network, config and optimizer."""
    from nnx_ppo_tpu_torch.envs import QuadrupedJoystick
    from nnx_ppo_tpu_torch.physics import DomainRandomization
    from nnx_ppo_tpu_torch.physics.terrain import rough_terrain

    return quadruped_leg(torch, QuadrupedJoystick(
        reuse_mass_matrix=True,
        randomize=DomainRandomization(**DR_RANGES),
        push_prob=0.02, push_force=50.0,
        terrain=rough_terrain(**ROUGH),
    ))


def heightgrid_leg(torch):
    """The data-terrain path: the quadruped on a 256 x 256 HeightGrid
    sampled from the rough terrain, held factor, no randomization or
    pushes; per control step one plane-sampler launch, then one
    control-step launch on the frozen planes."""
    from nnx_ppo_tpu_torch.envs import QuadrupedJoystick

    return quadruped_leg(torch, QuadrupedJoystick(reuse_mass_matrix=True, terrain=data_terrain()))


def xlafactor_leg(torch):
    """The passed-in-factor path: flat ground, the factor of M + dt D
    built outside the kernel once per control step, all ten substeps in
    one launch of the substeps kernel."""
    from nnx_ppo_tpu_torch.envs import QuadrupedJoystick

    return quadruped_leg(torch, QuadrupedJoystick(
        reuse_mass_matrix=True, pallas_in_kernel_factor=False, pallas_substeps_per_kernel=-1,
    ))


def manipulation_leg(torch, inner, max_len: int):
    """A manipulation training leg around ``inner``: time limit, the
    one-actor one-critic MLP with obs normalization, 4096 envs, T=20, 4
    epochs of 4 shuffled minibatches."""
    from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
    from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    env = EpisodeWrapper(inner, max_len=max_len)
    networks = make_mlp_actor_critic(
        env.observation_size, env.action_size, [128, 128], [256, 256], 0,
        entropy_weight=2e-3, normalize_obs=True,
    )
    config = PPOConfig(n_envs=4096, rollout_length=20)
    return env, networks, config, make_optimizer(config.learning_rate)


def pusher_leg(torch):
    """The pusher path: arm, free ball and their cross contact, 16
    substeps of 1.25 ms in one scene-kernel launch per control step."""
    from nnx_ppo_tpu_torch.envs import ArmPush

    return manipulation_leg(torch, ArmPush(), 200)


def reacher_leg(torch):
    """The reacher path: the arm alone (a scene of one tree), 4 substeps
    of 5 ms in one scene-kernel launch per control step."""
    from nnx_ppo_tpu_torch.envs import ArmReacher

    return manipulation_leg(torch, ArmReacher(), 150)


def check_finite(history: dict, torch) -> None:
    for name, v in history.items():
        check(bool(torch.isfinite(torch.as_tensor(v)).all()), f"{name} is finite")


def profile_step(torch, env, ts, config, optimizer, step_ms: float, profile_dir: str, label: str):
    """One profiled ppo_step: kernels per step, device busy time, idle
    share, and the share of each hand-written kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nnx_ppo_tpu_torch.algorithms import ppo_step

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts, _ = ppo_step(env, ts, config, optimizer)
        torch.cuda.synchronize()
    # Kernels only: user annotations (such as the optimizer's step
    # range) also carry a device time, as torch.profiler's table skips.
    device_events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    busy_ms = sum(e.self_device_time_total for e in device_events) / 1e3
    n_launches = sum(e.count for e in device_events)
    print(
        f"profile {label}: {n_launches} device kernels, device busy {busy_ms:.2f} ms per "
        f"ppo_step; unprofiled step {step_ms:.2f} ms; device idle share "
        f"{1 - busy_ms / step_ms:.3f}"
    )
    for kernel in ("control_step_kernel", "plane_sampler_kernel", "substeps_kernel",
                   "scene_step_kernel", "gae_kernel"):
        events = [e for e in device_events if kernel in e.key]
        if events:
            ms = sum(e.self_device_time_total for e in events) / 1e3
            print(
                f"profile {label}: {kernel} {sum(e.count for e in events)} launches, "
                f"{ms:.3f} ms, {ms / busy_ms:.3f} of device busy time, "
                f"{ms / step_ms:.3f} of the step"
            )
    path = os.path.join(profile_dir, f"{label}_ppo_step_profile.txt")
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))
        f.write("\n")
        f.write(prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))
    print(f"profile {label}: {path}")
    return ts


def flagship_path_phase(torch, kernels: list, profile_dir: str | None) -> dict:
    from nnx_ppo_tpu_torch.algorithms import new_training_state, ppo_multi_step
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda

    env, networks, config, optimizer = flagship(torch)
    per_step = config.n_envs * config.rollout_length
    updates = config.n_epochs * config.n_minibatches

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts = new_training_state(env, networks, config.n_envs, seed=0, optimizer=optimizer, device="cuda")
    ts, history = ppo_multi_step(
        env, ts, config, optimizer, FLAGSHIP_STEPS_CHECKED, return_history=True
    )
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(ts.steps_taken == FLAGSHIP_STEPS_CHECKED * per_step, f"steps_taken {ts.steps_taken}")
    check(gae_cuda.launches == updates * FLAGSHIP_STEPS_CHECKED, f"gae launches {gae_cuda.launches}")
    check_finite(history, torch)

    t0 = time.perf_counter()
    ts, history = ppo_multi_step(
        env, ts, config, optimizer, FLAGSHIP_STEPS_TIMED, return_history=True
    )
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    n_steps = FLAGSHIP_STEPS_CHECKED + FLAGSHIP_STEPS_TIMED
    check(ts.steps_taken == n_steps * per_step, f"steps_taken {ts.steps_taken}")
    check(launches["gae_cuda"] == updates * n_steps, f"launches {launches}")
    check(all(n == 0 for name, n in launches.items() if name != "gae_cuda"),
          f"the flagship launches no physics kernel: {launches}")
    check_finite(history, torch)

    step_ms = timed_s / FLAGSHIP_STEPS_TIMED * 1e3
    if profile_dir:
        ts = profile_step(torch, env, ts, config, optimizer, step_ms, profile_dir, "flagship")
    return {
        "launches": launches,
        "first_call_s": first_s,
        "train_sps_first_call": FLAGSHIP_STEPS_CHECKED * per_step / first_s,
        "step_ms": step_ms,
        "train_sps": FLAGSHIP_STEPS_TIMED * per_step / timed_s,
        "state": ts,
        "actor_loss": float(history["losses/actor/mean"][-1]),
        "critic_loss": float(history["losses/critic/mean"][-1]),
    }


def physics_path_phase(torch, kernels: list, profile_dir: str | None, label: str, leg,
                       n_checked: int, n_timed: int, per_step: dict,
                       n_noshuffle: int = 0) -> dict:
    """One quadruped or manipulation path at full width: ``n_checked``
    checked and ``n_timed`` timed steps with shuffled minibatches, then
    ``n_noshuffle`` timed steps with contiguous ones. ``per_step`` maps
    each kernel wrapper's name to its launches per ``ppo_step``."""
    from nnx_ppo_tpu_torch.algorithms import new_training_state, ppo_multi_step

    env, networks, config, optimizer = leg(torch)
    per_env_steps = config.n_envs * config.rollout_length

    def check_counts(n_steps: int) -> None:
        for k in kernels:
            check(k.launches == per_step[k.__name__] * n_steps,
                  f"{label}: {k.__name__} launches {k.launches} after {n_steps} steps")

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts = new_training_state(env, networks, config.n_envs, seed=0, optimizer=optimizer, device="cuda")
    ts, history = ppo_multi_step(env, ts, config, optimizer, n_checked, return_history=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(ts.steps_taken == n_checked * per_env_steps, f"steps_taken {ts.steps_taken}")
    check_counts(n_checked)
    check_finite(history, torch)
    obs = ts.env_states.obs
    if isinstance(obs, dict):
        check(obs["proprio"].shape == (config.n_envs, 42), "proprio obs shape")
        critic_key = "losses/critic/tracking/mean"
    else:
        check(obs.shape == (config.n_envs, env.observation_size), "obs shape")
        check(bool(torch.isfinite(obs).all()), "obs is finite")
        critic_key = "losses/critic/mean"

    t0 = time.perf_counter()
    ts, history = ppo_multi_step(env, ts, config, optimizer, n_timed, return_history=True)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    n_steps = n_checked + n_timed
    check_counts(n_steps)
    check_finite(history, torch)

    result = {}
    if n_noshuffle:
        noshuffle = dataclasses.replace(config, shuffle_minibatches=False)
        t0 = time.perf_counter()
        ts, history_ns = ppo_multi_step(
            env, ts, noshuffle, optimizer, n_noshuffle, return_history=True
        )
        torch.cuda.synchronize()
        noshuffle_s = time.perf_counter() - t0
        n_steps += n_noshuffle
        check_counts(n_steps)
        check_finite(history_ns, torch)
        result["noshuffle_step_ms"] = noshuffle_s / n_noshuffle * 1e3
        result["sps_noshuffle"] = n_noshuffle * per_env_steps / noshuffle_s
    launches = {k.__name__: k.launches for k in kernels}
    check(ts.steps_taken == n_steps * per_env_steps, f"steps_taken {ts.steps_taken}")

    step_ms = timed_s / n_timed * 1e3
    if profile_dir:
        ts = profile_step(torch, env, ts, config, optimizer, step_ms, profile_dir, label)
    result.update({
        "launches": launches,
        "n_steps": n_steps,
        "first_call_s": first_s,
        "step_ms": step_ms,
        "sps": n_timed * per_env_steps / timed_s,
        "state": ts,
        "env": env,
        "config": config,
        "actor_loss": float(history["losses/actor/mean"][-1]),
        "critic_loss": float(history[critic_key][-1]),
    })
    return result


def loss_reference_phase(torch, label: str, env, config, ts) -> float:
    """Loss and gradients on the card (one GAE launch for all reward keys)
    against the CPU (plain GAE) for one full-width minibatch of a fresh
    rollout, and against the card's loss with one GAE launch per key (the
    calls that gae_per_key replaced): the same bits."""
    from nnx_ppo_tpu_torch.algorithms import ppo as ppo_module
    from nnx_ppo_tpu_torch.algorithms import ppo_loss
    from nnx_ppo_tpu_torch.algorithms.ppo import ReplayMinibatch
    from nnx_ppo_tpu_torch.algorithms.rollout import unroll_env
    from nnx_ppo_tpu_torch.core.struct import tree_map
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda

    net_gpu = ts.networks
    with torch.no_grad():
        _, _, rollout = unroll_env(
            env, ts.env_states, net_gpu, ts.network_states, config.rollout_length, ts.generator
        )
    width = config.n_envs // config.n_minibatches
    sel = torch.arange(width, device="cuda")
    view = ReplayMinibatch.from_rollout(rollout).gather(sel, lambda x, s: x[:, s], lambda x, s: x[s])
    kw = dict(
        clip_range=config.clip_range,
        normalize_advantages=True,
        combine_advantages=config.combine_advantages,
        discounting_factor=config.discounting_factor,
        gae_lambda=config.gae_lambda,
        critic_loss_weight=1.0,
        logging_level=config.logging_level,
    )
    net_cpu = copy.deepcopy(net_gpu).cpu()
    view_cpu = tree_map(lambda x: x.cpu(), view)
    before = gae_cuda.launches
    net_gpu.zero_grad(set_to_none=True)
    loss_gpu, _ = ppo_loss(net_gpu, tree_map(lambda x: x[:width], ts.network_states), view, **kw)
    loss_gpu.backward()
    check(gae_cuda.launches == before + 1, "the loss on the card launched the GAE kernel once")
    loss_cpu, _ = ppo_loss(
        net_cpu, tree_map(lambda x: x[:width].cpu(), ts.network_states), view_cpu, **kw
    )
    loss_cpu.backward()
    # float32 on both; sums over T * width samples in another order.
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, rtol=1e-4, atol=1e-5)
    max_rel = 0.0
    for p_gpu, p_cpu in zip(net_gpu.parameters(), net_cpu.parameters()):
        torch.testing.assert_close(p_gpu.grad.cpu(), p_cpu.grad, rtol=1e-3, atol=1e-5)
        scale = p_cpu.grad.abs().max().clamp(min=1e-12)
        max_rel = max(max_rel, ((p_gpu.grad.cpu() - p_cpu.grad).abs().max() / scale).item())
    grads = [p.grad for p in net_gpu.parameters()]
    net_gpu.zero_grad(set_to_none=True)

    def one_launch_per_key(rewards, values, last_values, done, truncated, lambda_, gamma):
        done = tree_map(lambda _: done, rewards) if torch.is_tensor(done) else done
        truncated = tree_map(lambda _: truncated, rewards) if torch.is_tensor(truncated) else truncated
        return tree_map(lambda r, v, lv, d, tr: gae_cuda(r, v, lv, d, tr, lambda_, gamma),
                        rewards, values, last_values, done, truncated)

    n_keys = len(view.rewards) if isinstance(view.rewards, dict) else 1
    shipped = ppo_module.gae_per_key
    before = gae_cuda.launches
    try:
        ppo_module.gae_per_key = one_launch_per_key
        loss_per_key, _ = ppo_loss(net_gpu, tree_map(lambda x: x[:width], ts.network_states), view,
                                   **kw)
        loss_per_key.backward()
    finally:
        ppo_module.gae_per_key = shipped
    check(gae_cuda.launches == before + n_keys, "one launch per key")
    same = bool(torch.equal(loss_per_key, loss_gpu)) and all(
        torch.equal(p.grad, g) for p, g in zip(net_gpu.parameters(), grads))
    check(same, f"{label}: the loss with one GAE launch equals the per-key launches' to the bit")
    net_gpu.zero_grad(set_to_none=True)
    print(f"reference {label}: loss cuda {loss_gpu.item():.6f} cpu {loss_cpu.item():.6f}; "
          f"max grad diff / max |grad| {max_rel:.3g}; with one GAE launch per key ({n_keys}) "
          "loss and gradients torch.equal True")
    return abs(loss_gpu.item() - loss_cpu.item())


def env_step_reference_phase(torch, label: str, env, kernels: list, per_env_step: dict) -> None:
    """One step of a quadruped path's env on the card (its kernels)
    against the CPU (plain versions): same state, action and draws.
    ``per_env_step`` maps each kernel wrapper's name to its launches per
    env step. float32; one control step of ten substeps: qpos 2e-4, qvel
    2e-3; obs 2e-3 (it holds qvel); rewards 1e-4; contact force rtol 5e-3
    / atol 5e-2."""
    from nnx_ppo_tpu_torch.core.struct import tree_map

    legged, B = env.env, 128
    generator = torch.Generator(device="cuda")
    generator.manual_seed(11)
    state = legged.reset(B, generator)
    action = 2.4 * torch.rand((B, legged.action_size), generator=generator, device="cuda") - 1.2
    push = None
    if legged.push_force > 0.0:
        push = legged._draw_push(B, generator)
        push = (torch.arange(B, device="cuda") % 4 == 0, push[1])  # one env in four is pushed
    resample = legged._draw_resample(B, generator)
    before = {k.__name__: k.launches for k in kernels}
    on_card = legged._step_from(state, action, push, resample, None)
    after_card = {k.__name__: k.launches for k in kernels}
    check(all(after_card[n] == before[n] + per_env_step[n] for n in before),
          f"{label}: env.step on the card launched its kernels ({before} -> {after_card})")
    to_cpu = lambda tree: tree_map(lambda x: x.cpu(), tree)
    on_cpu = legged._step_from(
        to_cpu(state), action.cpu(), None if push is None else to_cpu(push), to_cpu(resample), None
    )
    check({k.__name__: k.launches for k in kernels} == after_card,
          f"{label}: env.step on the CPU ran the plain versions")
    torch.cuda.synchronize()
    got, want = to_cpu(on_card), on_cpu
    check(bool((want.metrics["contact_force"] > 0).any()), "feet are in contact")
    torch.testing.assert_close(got.data["qpos"], want.data["qpos"], rtol=0, atol=2e-4)
    torch.testing.assert_close(got.data["qvel"], want.data["qvel"], rtol=0, atol=2e-3)
    for key in want.obs:
        torch.testing.assert_close(got.obs[key], want.obs[key], rtol=0, atol=2e-3)
    for key in want.reward:
        torch.testing.assert_close(got.reward[key], want.reward[key], rtol=0, atol=1e-4)
    torch.testing.assert_close(got.done, want.done, rtol=0, atol=0)
    torch.testing.assert_close(
        got.metrics["contact_force"], want.metrics["contact_force"], rtol=5e-3, atol=5e-2
    )
    print(
        f"reference env.step {label}: max_abs_err qpos "
        f"{(got.data['qpos'] - want.data['qpos']).abs().max().item():.3g} qvel "
        f"{(got.data['qvel'] - want.data['qvel']).abs().max().item():.3g} over {B} envs"
    )


def manipulation_env_step_reference_phase(torch, label: str, env, scene_wrapper) -> None:
    """Two steps of a manipulation env on the card (the scene kernel)
    against the CPU (the plain version) from the same reset state and
    actions; the second step starts from a moving state. float32; sinf,
    cosf and sqrtf of the card against the CPU's: qpos 2e-4, qvel 2e-3,
    obs 2e-3 (it holds qvel), reward and distances 1e-4."""
    from nnx_ppo_tpu_torch.core.struct import tree_map

    inner, B = env.env, 128
    generator = torch.Generator(device="cuda")
    generator.manual_seed(11)
    on_card = inner.reset(B, generator)
    actions = 2.4 * torch.rand((2, B, inner.action_size), generator=generator, device="cuda") - 1.2
    to_cpu = lambda tree: tree_map(lambda x: x.cpu(), tree)
    on_cpu = to_cpu(on_card)
    before = scene_wrapper.launches
    for action in actions:
        on_card = inner.step(on_card, action)
    check(scene_wrapper.launches == before + 2, f"{label}: env.step on the card launched the kernel")
    for action in actions.cpu():
        on_cpu = inner.step(on_cpu, action)
    check(scene_wrapper.launches == before + 2, f"{label}: env.step on the CPU ran the plain version")
    torch.cuda.synchronize()
    got, want = to_cpu(on_card), on_cpu
    worst = {"qpos": 0.0, "qvel": 0.0}
    for key in want.data:
        kind = "qvel" if "qvel" in key else "qpos"
        torch.testing.assert_close(got.data[key], want.data[key], rtol=0,
                                   atol=2e-3 if kind == "qvel" else 2e-4)
        worst[kind] = max(worst[kind], (got.data[key] - want.data[key]).abs().max().item())
    torch.testing.assert_close(got.obs, want.obs, rtol=0, atol=2e-3)
    torch.testing.assert_close(got.reward, want.reward, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.done, want.done, rtol=0, atol=0)
    for key in want.metrics:
        torch.testing.assert_close(got.metrics[key], want.metrics[key], rtol=0, atol=1e-4)
    print(f"reference env.step {label}: max_abs_err qpos {worst['qpos']:.3g} qvel "
          f"{worst['qvel']:.3g} over {B} envs and 2 steps")


def ab_kernels_phase(torch) -> dict:
    """GAE and the plane sampler at the paths' shapes, each call timed three
    ways (:func:`kernel_times`), for the package this run imports: with
    ``--package-root`` another checkout's, such as the parent commit's, so
    that two versions are compared in one chip call with one script. A
    package without ``gae_per_key`` runs one ``gae_cuda`` call per key, as
    its ``ppo_loss`` does."""
    from nnx_ppo_tpu_torch.ops import gae as gae_module

    lam, gamma = 0.95, 0.99
    per_key = hasattr(gae_module, "gae_per_key")
    out: dict = {"package": os.path.dirname(os.path.dirname(os.path.abspath(gae_module.__file__))),
                 "gae_per_key": per_key}
    for label, (T, B, n_keys) in GAE_PATH_SHAPES.items():
        inputs = gae_path_inputs(T, B, n_keys, torch)
        out[f"gae_{label}"] = kernel_times(gae_call(inputs, lam, gamma), "gae_kernel", torch,
                                           per_call=1 if per_key else n_keys)
    plan, args = plane_sampler_case("B=2048 on the 256x256 table", torch)
    out["plane_sampler"] = kernel_times(lambda: plan.sample_planes_cuda(args[0]),
                                        "plane_sampler_kernel", torch, n_wrapper=200, n_profile=50)
    out["floor"] = floor_kernel_times(torch)
    for name in ("gae_flagship", "gae_quadruped", "plane_sampler"):
        t = out[name]
        print(f"ab {name}: wrapper {1e3 * t['wrapper_ms']:.2f} us, kernel "
              f"{1e3 * t['kernel_device_ms']:.3f} us per launch (profiler), {1e3 * t['graph_ms']:.3f}"
              f" us per call (CUDA graph), {t['device_kernels_per_call']:.1f} device kernels and "
              f"{1e3 * t['device_ms_per_call']:.3f} us of device time per call")
    return out


def learning_phase(torch, iterations: int) -> None:
    """train_ppo on the flagship for ``iterations`` PPO iterations, with a
    deterministic eval (64 envs, 500 steps) every tenth of the run."""
    from nnx_ppo_tpu_torch.algorithms import EvalConfig, TrainConfig, train_ppo

    env, networks, config, _ = flagship(torch)
    per_step = config.n_envs * config.rollout_length
    train_config = TrainConfig(
        ppo=dataclasses.replace(config, total_steps=iterations * per_step),
        eval=EvalConfig(
            every_steps=max(iterations // 10, 1) * per_step, n_envs=64, max_episode_length=500
        ),
        seed=0,
    )
    t0 = time.perf_counter()
    res = train_ppo(env, networks, train_config, device="cuda")
    for row in res.eval_history:
        print(
            f"learn: step {row['step']} episode_reward p50 {row['episode_reward/p50']:.2f} "
            f"lifespan_mean {row['lifespan_mean']:.1f}"
        )
    print(f"learn: {iterations} iterations in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", default=None)
    parser.add_argument("--learn", metavar="ITERATIONS", type=int, default=0)
    parser.add_argument("--variants", action="store_true")
    parser.add_argument("--phases", action="store_true")
    parser.add_argument("--ab-kernels", action="store_true")
    parser.add_argument("--package-root", metavar="DIR", default=None)
    args = parser.parse_args()
    if args.package_root:
        # Import nnx_ppo_tpu_torch from another checkout (--ab-kernels).
        sys.path.insert(0, os.path.abspath(args.package_root))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nnx_ppo_tpu_torch.ops import cuda_build
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda
    from nnx_ppo_tpu_torch.physics.cuda_scene_step import scene_step_cuda
    from nnx_ppo_tpu_torch.physics.cuda_step import (
        control_step_cuda,
        plane_sampler_cuda,
        substeps_cuda,
    )

    card = card_line()
    print(f"card: {card}")
    if args.ab_kernels:
        print(json.dumps({"ab_kernels": ab_kernels_phase(torch)}))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                   "kind": torch.cuda.get_device_name(0),
                                                   "count": torch.cuda.device_count()}}))
        return 0

    t0 = time.perf_counter()
    specs = {control_step_case(name, torch)[0].kernel_spec for name in CONTROL_STEP_CASES}
    # The data-terrain plan names the plane sampler's library and the
    # flat-ground control-step library, whose second entry point is the
    # substeps kernel.
    sampler_plan = plane_sampler_case(next(iter(PLANE_SAMPLER_CASES)), torch)[0]
    specs.update(sampler_plan.kernel_specs)
    # The sampler at every number of lanes per env of its sweep.
    specs.update(sampler_variant(sampler_plan, group, 128).sampler_spec for group in SAMPLER_GROUPS)
    # The scene kernel at the pusher's and at the reacher's sizes.
    specs.update(scene_step_case(name, torch)[0].kernel_spec for name in SCENE_STEP_CASES)
    # With --profile, also print what ptxas says of each kernel
    # (registers, stack, spills).
    cuda_build.build(["gae", *sorted(specs)], verbose=bool(args.profile))
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, {1 + len(specs)} libraries "
          "at once)")

    wrappers = [gae_cuda, control_step_cuda, plane_sampler_cuda, substeps_cuda, scene_step_cuda]
    gae_kernel = gae_kernel_phase(torch)
    control_kernel = control_step_kernel_phase(torch, args.variants)
    sampler_kernel = plane_sampler_kernel_phase(torch)
    substeps_kernel = substeps_kernel_phase(torch, bool(args.profile))
    scene_kernel = scene_step_kernel_phase(torch, args.variants)

    flagship_path = flagship_path_phase(torch, wrappers, args.profile)
    flagship_env, _, flagship_config, _ = flagship(torch)
    loss_reference_phase(torch, "flagship", flagship_env, flagship_config,
                         flagship_path["state"])

    # Launches per ppo_step: one env step per rollout step (T = 20), one
    # GAE per minibatch update (16) for all reward keys (2 on the quadruped
    # paths, 1 on the manipulation paths).
    none = {k.__name__: 0 for k in wrappers}
    per_step = {
        "physics": dict(none, gae_cuda=16, control_step_cuda=20),
        "heightgrid": dict(none, gae_cuda=16, control_step_cuda=20, plane_sampler_cuda=20),
        "xlafactor": dict(none, gae_cuda=16, substeps_cuda=20),
        "pusher": dict(none, gae_cuda=16, scene_step_cuda=20),
        "reacher": dict(none, gae_cuda=16, scene_step_cuda=20),
    }
    physics_wrappers = wrappers[1:4]

    def per_env_step(label: str) -> dict:
        return {k.__name__: per_step[label][k.__name__] // 20 for k in physics_wrappers}

    physics_path = physics_path_phase(
        torch, wrappers, args.profile, "physics", physics_leg, PHYSICS_STEPS_CHECKED,
        PHYSICS_STEPS_TIMED, per_step["physics"], PHYSICS_STEPS_NOSHUFFLE,
    )
    loss_reference_phase(torch, "physics", physics_path["env"], physics_path["config"],
                         physics_path["state"])
    heightgrid_path = physics_path_phase(
        torch, wrappers, args.profile, "heightgrid", heightgrid_leg, HEIGHTGRID_STEPS_CHECKED,
        HEIGHTGRID_STEPS_TIMED, per_step["heightgrid"],
    )
    xlafactor_path = physics_path_phase(
        torch, wrappers, args.profile, "xlafactor", xlafactor_leg, XLAFACTOR_STEPS_CHECKED,
        XLAFACTOR_STEPS_TIMED, per_step["xlafactor"],
    )
    quadruped_paths = {
        "physics": physics_path, "heightgrid": heightgrid_path, "xlafactor": xlafactor_path,
    }
    manipulation_paths = {
        label: physics_path_phase(
            torch, wrappers, args.profile, label, leg, MANIPULATION_STEPS_CHECKED,
            MANIPULATION_STEPS_TIMED, per_step[label],
        )
        for label, leg in (("pusher", pusher_leg), ("reacher", reacher_leg))
    }
    pusher_path = manipulation_paths["pusher"]
    loss_reference_phase(torch, "pusher", pusher_path["env"], pusher_path["config"],
                         pusher_path["state"])
    # After every path has been driven and its counts read: these steps
    # launch kernels too and must not count as the main paths'.
    for label, path in quadruped_paths.items():
        env_step_reference_phase(torch, label, path["env"], physics_wrappers, per_env_step(label))
    for label, path in manipulation_paths.items():
        manipulation_env_step_reference_phase(torch, label, path["env"], scene_step_cuda)
    if args.learn:
        learning_phase(torch, args.learn)
    if args.phases:
        phases_phase(torch)

    # Launches on the main paths only (the comparisons above do not
    # count: every count was set to 0 just before each path).
    by_path = {"flagship": flagship_path["launches"]}
    training_paths = {**quadruped_paths, **manipulation_paths}
    by_path.update({label: path["launches"] for label, path in training_paths.items()})
    kernel_rows = {
        "gae_cuda": gae_kernel, "control_step_cuda": control_kernel,
        "plane_sampler_cuda": sampler_kernel, "substeps_cuda": substeps_kernel,
        "scene_step_cuda": scene_kernel,
    }
    for wrapper_name, kernel in kernel_rows.items():
        kernel["launches_by_path"] = {k: p[wrapper_name] for k, p in by_path.items()}
        kernel["launches"] = sum(kernel["launches_by_path"].values())
        check(kernel["launches"] > 0, f"{kernel['name']} was launched on a main path")

    print(
        f"flagship: {FLAGSHIP_STEPS_CHECKED + FLAGSHIP_STEPS_TIMED} ppo_steps, "
        f"gae launches {by_path['flagship']['gae_cuda']}, actor loss "
        f"{flagship_path['actor_loss']:.5f}, critic loss {flagship_path['critic_loss']:.5f}"
    )
    print(
        f"train_sps {flagship_path['train_sps']:.1f} (step {flagship_path['step_ms']:.2f} ms over "
        f"{FLAGSHIP_STEPS_TIMED} steps; first call incl. set-up "
        f"{flagship_path['train_sps_first_call']:.1f}) on {card}"
    )
    timed = {"physics": PHYSICS_STEPS_TIMED, "heightgrid": HEIGHTGRID_STEPS_TIMED,
             "xlafactor": XLAFACTOR_STEPS_TIMED, "pusher": MANIPULATION_STEPS_TIMED,
             "reacher": MANIPULATION_STEPS_TIMED}
    for label, path in training_paths.items():
        counts = ", ".join(f"{name} {n}" for name, n in by_path[label].items())
        critic = "critic loss (tracking)" if label in quadruped_paths else "critic loss"
        print(
            f"{label}: {path['n_steps']} ppo_steps, launches: {counts}; actor loss "
            f"{path['actor_loss']:.5f}, {critic} {path['critic_loss']:.5f}"
        )
        print(
            f"{label}_sps {path['sps']:.1f} (step {path['step_ms']:.2f} ms over "
            f"{timed[label]} steps, shuffled; first call incl. set-up "
            f"{path['first_call_s']:.2f} s) on {card}"
        )
    print(
        f"physics_sps_noshuffle {physics_path['sps_noshuffle']:.1f} (step "
        f"{physics_path['noshuffle_step_ms']:.2f} ms over {PHYSICS_STEPS_NOSHUFFLE} steps, "
        f"contiguous minibatches) on {card}"
    )
    factor_share = 20 * substeps_kernel["factor_build_ms"] / xlafactor_path["step_ms"]
    print(
        f"xlafactor: the factor build outside the kernel, {substeps_kernel['factor_build_ms']:.3f} "
        f"ms per call alone, 20 per step, is {factor_share:.3f} of the {xlafactor_path['step_ms']:.2f} "
        "ms step"
    )
    print(json.dumps({"kernels": list(kernel_rows.values())}))
    print(f"card: {card}")
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
