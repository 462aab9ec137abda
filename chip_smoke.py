#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nnx_ppo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR] [--learn N] [--variants] [--phases]
    python3 chip_smoke.py --ab-kernels [--package-root DIR]

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit, from nvidia-smi;
2. build: every hand-written kernel of the training paths (GAE, the
   physics control step with its substeps entry point at the quadruped's,
   the humanoid's and the MJCF quadruped's sizes, the plane sampler, the
   scene control step
   at the pusher's and the reacher's sizes), compiled with nvcc from the
   sources in nnx_ppo_tpu_torch/csrc/, all at once;
3. kernels: each kernel against its plain PyTorch version on the card at
   the training paths' shapes and at ragged ones (a batch that ends inside
   a warp; for the scene kernel also a two-tree scene with every joint
   type; for GAE every reward key of a minibatch in one launch; for the
   control step also the humanoid, held at 8192 envs, exact with
   self-collision and joint limits at 2048, and both ragged, and the MJCF
   quadruped at 2048 and 33 envs, held to the bit), printing
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
   (ArmReacher, 150-step limit, the arm alone, 4 substeps); the humanoid
   (HumanoidJoystick, held factor, 8192 envs, T=20, the physics leg's net)
   and the full humanoid (self-collision pairs and joint limits, the
   factor rebuilt at every substep, 2048 envs), one control-step launch per
   env step at the humanoid's sizes; and two analytic paths with no
   physics kernel: locomotion (JoystickLocomotion, 4096 envs, the physics
   leg's net) and heavy physics (NLinkSwingup with 5 links, 8192 envs, MLP
   256x2); and the networks paths, GAE only, on CartpoleBalance with a
   500-step limit: gru_1024 (GRU(obs, 64) actor and critic, 1024 envs,
   T=30, the fused replay with the GRUs' input projections hoisted),
   gru_1024_unfused (the same with fused_replay=False: the whole-net step
   scan), population_graph_1024 (sensor -> core(64, tanh) with a delay-1
   self-loop -> motor, critic MLP 256, 1024 envs, T=30) and
   mlp_wide_bf16_8192 (actor 1024x4, critic 2048x2, compute_dtype bf16,
   8192 envs, T=20); and on the flat quadruped (held factor, no
   randomization or pushes, the physics leg's net, 2048 envs, T=20):
   quadruped_2048_pallas_bf16store (replay_store_dtype="bfloat16") and,
   through new_distillation_state and distillation_multi_step,
   distill_quadruped_2048 and distill_quadruped_2048_noshuffle (the
   teacher in eval mode, the student its copy with jittered parameters;
   20 control steps a step, no GAE); and (PR 10) mjcf_quadruped_2048 (the
   MJCF quadruped of examples/mjcf_import.py, built from its saved import
   through legged_from_import: kp 60 and action scales from the position
   actuators, the crouch at 0.312 m, held factor; the physics leg's net,
   2048 envs, T=20; the control step at the imported model's sizes) and
   quadruped_2048_fastM_generic (QuadrupedJoystick on the generic engine,
   substep_impl="xla", depthwise=False, held factor: eager PyTorch, no
   physics kernel; one checked and one timed step), each with one more
   ppo_step under the profiler for its device kernels, busy time and idle
   share. Every path prints the replay layout its config resolves to
   ("auto": batch-major for a fully replay-time-static network, as the
   JAX package resolves it);
5. reference: for the flagship, the physics leg, the pusher, both
   humanoid paths and both analytic paths the PPO
   loss and its gradients on the card against the same computation on
   the CPU (plain versions) for one minibatch, and against the card's
   own with one GAE launch per reward key (the same bits), and for each
   quadruped, humanoid and manipulation path one env step on the card (kernels)
   against the CPU (plain versions) from the same state, action and
   draws; the same loss reference for the networks paths (the bf16 one at
   its own stated limits, on 512 of its 2048 minibatch columns), for an
   LSTM actor-critic and a Dense -> Delay(2) -> AR1 bottleneck -> sampler
   actor (no timed steps), and the GRU path's fused replay against its
   whole-net scan on the card; the batch-major loss against the
   time-major one on the card (flagship, physics leg); the bf16 store
   against the float32 one on a bf16-compute net (torch.equal); the
   distillation loss on the card against the CPU; and GAE's batch-major
   launch (the [B, T] keys of a batch-major minibatch read in place) to
   the bit with gae_scan on the transposed views at [512, 20] x 2, [256,
   30] and a ragged 33 envs, with the profiler's count of the kernels
   around it; and (PR 10) each physics kernel against the generic engine
   on the card, an independent implementation (the control step at the
   physics leg's quadruped and at the MJCF quadruped through the env,
   qpos 2e-4 / qvel 2e-3; the scene kernel on the reacher and the pusher,
   qpos 2e-5 / qvel 2e-4 / normals 1e-4: the JAX package's tolerances
   for the same checks), each beside what a generic step of one substep
   fewer reads, and the generic engine's forward dynamics on the card
   against the CPU on trees with slide and ball joints;
6. one env: every physics kernel launched for a batch of one
   (the video's render rollout; the control step held, exact, on flat
   ground and on sampled planes, the plane sampler, the substeps kernel,
   the scene step at the pusher's and the reacher's sizes), each output
   equal to the bit with the plain version, with its device time;
   checkpoint: the flagship and the physics leg through train_ppo with
   make_checkpoint_fn (anneal_lr), 2k iterations twice from one seed,
   then the checkpoint at k loaded into a fresh template and trained to
   2k: whether the two uninterrupted runs are equal to the bit (then the
   resumed one must be), the resumed run's largest difference, save and
   load ms and bytes on disk; and a distill_quadruped_2048 state's round
   trip, equal to the bit; video: train_ppo with video on the flagship
   (500-step episode), and the render rollout of one env plus render, 200
   steps, on the physics leg's quadruped, the data-terrain quadruped and
   the pusher: the frames' shape, video_sps, and the kernels launched per
   env step (each rollout step one launch of each of its kernels at one
   env). Each of these runs has every kernel's count set to 0 just before
   and read just after.

It prints a ``kernels`` JSON line (each kernel's design, and its
registers, stack, spills and shared memory from ptxas and the launch), the
card line, and last ``{"ok": true, "device": {...}}``. With no CUDA device
it exits 1 and prints no result. ``--profile DIR`` also writes
torch.profiler tables of one training step of each path to DIR, and
traces one more ppo_step of the flagship and of the physics leg with
``utils.profiling.trace`` (into DIR), printing the host ms and the device
ms of its ``unroll_env`` and ``ppo_update`` ranges as shares of the
step's; ``--learn
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
import importlib
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
BF16_FLOPS_PER_S = 989e12

FLAGSHIP_STEPS_CHECKED = 2
FLAGSHIP_STEPS_TIMED = 3
PHYSICS_STEPS_CHECKED = 2
PHYSICS_STEPS_TIMED = 3
PHYSICS_STEPS_NOSHUFFLE = 2
MJCF_STEPS_CHECKED = 2
MJCF_STEPS_TIMED = 3
# The generic engine in eager PyTorch: tens of thousands of launches per
# env step, so one checked and one timed ppo_step.
GENERIC_STEPS_CHECKED = 1
GENERIC_STEPS_TIMED = 1
HEIGHTGRID_STEPS_CHECKED = 2
HEIGHTGRID_STEPS_TIMED = 3
XLAFACTOR_STEPS_CHECKED = 1
XLAFACTOR_STEPS_TIMED = 3
MANIPULATION_STEPS_CHECKED = 2
MANIPULATION_STEPS_TIMED = 3
HUMANOID_STEPS_CHECKED = 2
HUMANOID_STEPS_TIMED = 3
ANALYTIC_STEPS_CHECKED = 2
ANALYTIC_STEPS_TIMED = 3


# Loss and gradients on the card against the CPU: float32 on both, sums
# over T * width samples in another order. ``grad_of_max`` adds that
# share of the tensor's largest entry to each entry's atol.
LOSS_LIMITS = dict(loss_rtol=1e-4, loss_atol=1e-5, grad_rtol=1e-3, grad_atol=1e-5, grad_of_max=0.0)
# bf16 compute (mlp_wide_bf16_8192): the loss agrees as closely as the
# float32 paths' (H100: 1.0e-4 to 2.0e-4 of rtol 1e-3 in four runs) and
# keeps their limits. The gradients are bf16 values, and each layer's
# input gradient is rounded to bf16 too, so an entry, near 0 as well,
# differs by a share of its tensor's scale: the H100 read at most 0.99% of
# the tensor's largest entry (widths 2048 and 512, four runs: 0.64%,
# 0.99%, 0.99%, 0.62%). The limit is two bf16 steps of that entry, 2^-6.
BF16_LOSS_LIMITS = dict(LOSS_LIMITS, grad_rtol=0.0, grad_of_max=2.0**-6)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int, torch, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
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
# The batch-major minibatches (every static path since "auto" resolves as
# JAX's does), read in place: the quadruped paths' [b=512, T=20] x 2 keys,
# the flagship's [256, 30], and a ragged b=33 (last block one env).
GAE_BATCH_MAJOR_SHAPES = {"quadruped": (20, 512, 2), "flagship": (30, 256, 1),
                          "ragged": (20, 33, 2)}
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


def batch_major_inputs(inputs: tuple) -> tuple:
    """:func:`gae_path_inputs`' tuple with every [T, B] tensor as a
    contiguous [B, T] one: the keys of a batch-major minibatch."""
    def bt(x):
        return x.T.contiguous() if x.ndim == 2 else x

    return tuple({k: bt(v) for k, v in x.items()} if isinstance(x, dict) else bt(x)
                 for x in inputs)


def gae_call_batch_major(inputs: tuple, lam: float, gamma: float):
    """One batch-major minibatch's GAE as ppo_loss runs it: the [B, T]
    keys read in place by one launch."""
    from nnx_ppo_tpu_torch.ops.gae import gae_per_key

    return lambda: gae_per_key(*inputs, lam, gamma, batch_major=True)


def gae_call_swapped(inputs: tuple, lam: float, gamma: float):
    """The same GAE as JAX's batch-major loss computes it
    (nnx_ppo_tpu/algorithms/ppo.py:599-619): each key swapped to [T, B],
    the time-major kernel, the advantages swapped back to [B, T]. Measured
    here beside the in-place launch; the port does not use it."""
    from nnx_ppo_tpu_torch.ops.gae import gae_per_key

    rewards, values, last, done, truncation = inputs
    tm = [{k: v.T for k, v in x.items()} if isinstance(x, dict) else x.T
          for x in (rewards, values)]
    return lambda: {k: a.T.contiguous() for k, a in gae_per_key(
        tm[0], tm[1], last, done.T, truncation.T, lam, gamma).items()}


def device_kernels_per_call(fn, torch, n: int = 20) -> dict:
    """Every device kernel torch.profiler sees over ``n`` calls of ``fn``
    (after a warm-up call): name -> launches per call. The profiler can
    drop records (see :func:`profile_calls`), so a count may read low,
    never high."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.count / n for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}


def gae_call(inputs: tuple, lam: float, gamma: float):
    """One minibatch's GAE as ppo_loss runs it: gae_per_key (one launch for
    all keys) where the package has it, else one gae_cuda call per key."""
    # The module: the package exports the function gae under its name.
    gae_module = importlib.import_module("nnx_ppo_tpu_torch.ops.gae")

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
    # The module: the package exports the function gae under its name.
    gae_module = importlib.import_module("nnx_ppo_tpu_torch.ops.gae")
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
    # Every key in one launch, bool flags: the paths' minibatches (the
    # flagship's, the quadruped's, the humanoid paths' [20, 2048] x 2 at
    # 8192 envs, heavy physics' [20, 2048] x 1, locomotion's [20, 1024] x
    # 2) and a ragged batch with three keys and per-key flags.
    for T, B, n_keys, per_key_flags in ((30, 256, 1, False), (20, 512, 2, False),
                                        (20, 2048, 2, False), (20, 2048, 1, False),
                                        (20, 1024, 2, False), (7, 33, 3, True)):
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

    # Batch-major keys [B, T], read in place: equal to the bit to gae_scan
    # on the transposed views; the profiler sees the one launch and no
    # copy before it (JAX's swap to [T, B] and back would add copies).
    batch_major = {}
    for label, (T, B, n_keys) in GAE_BATCH_MAJOR_SHAPES.items():
        inputs = batch_major_inputs(gae_path_inputs(T, B, n_keys, torch))
        before = gae_cuda.launches
        got = gae_per_key(*inputs, lam, gamma, batch_major=True)
        check(gae_cuda.launches == before + 1, f"batch-major gae [{B}, {T}] x {n_keys}: one launch")
        got = got if isinstance(got, dict) else {"key0": got}
        for k, (r, v, last, d, tr) in gae_keys(inputs).items():
            want = gae_scan(r.T, v.T, last, d.T, tr.T, lam, gamma).T
            max_err = max(max_err, (got[k] - want).abs().max().item())
            check(got[k].shape == (B, T) and bool(torch.equal(got[k], want)),
                  f"batch-major gae [{B}, {T}] {k} equals gae_scan on the transposed views to the bit")
        seen = device_kernels_per_call(gae_call_batch_major(inputs, lam, gamma), torch)
        check(all("gae_kernel" in k for k in seen) and 0.5 <= sum(seen.values()) <= 1,
              f"batch-major gae [{B}, {T}]: the profiler sees the GAE launch and no other kernel "
              f"(no copy before it): {seen}")
        row = {"shape_b_t_keys": [B, T, n_keys], "device_kernels_in_place": seen}
        if n_keys > 1 or label == "flagship":
            swapped = device_kernels_per_call(gae_call_swapped(
                inputs if n_keys > 1 else ({"key0": inputs[0]}, {"key0": inputs[1]},
                                           {"key0": inputs[2]}, inputs[3], inputs[4]),
                lam, gamma), torch)
            row["device_kernels_swapped"] = sum(swapped.values())
        batch_major[label] = row
        print(f"gae batch-major [{B}, {T}] x {n_keys} key(s): one launch, every key torch.equal True "
              f"with gae_scan on the transposed views; device kernels per call in place "
              f"{sum(seen.values()):g} ({', '.join(seen)}); swapped to [T, B] and back as JAX's "
              f"loss does: {row.get('device_kernels_swapped')}")

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
    for label, (T, B, n_keys) in GAE_BATCH_MAJOR_SHAPES.items():
        if label == "ragged":
            continue
        inputs = batch_major_inputs(gae_path_inputs(T, B, n_keys, torch))
        times = kernel_times(gae_call_batch_major(inputs, lam, gamma), "gae_kernel", torch)
        times["swapped_graph_ms"] = graph_device_ms(gae_call_swapped(
            inputs if n_keys > 1 else ({"key0": inputs[0]}, {"key0": inputs[1]},
                                       {"key0": inputs[2]}, inputs[3], inputs[4]), lam, gamma),
            100, torch)
        keys = [(r.T, v.T, last, d.T, tr.T) for r, v, last, d, tr in gae_keys(inputs).values()]
        times["plain_ms"] = time_ms(lambda: [gae_scan(*key, lam, gamma).T for key in keys], 20,
                                    torch)
        times["bound_ms"], times["bound_by"] = gae_bound_ms(T, B, n_keys)
        batch_major[label].update(times)
        print(f"gae batch-major [{B}, {T}] x {n_keys} key(s) in one launch: wrapper "
              f"{1e3 * times['wrapper_ms']:.2f} us, kernel {1e3 * times['kernel_device_ms']:.3f} us "
              f"(profiler), {1e3 * times['graph_ms']:.3f} us (CUDA graph; swapped to [T, B] and "
              f"back {1e3 * times['swapped_graph_ms']:.3f} us), "
              f"{times['device_kernels_per_call']:.1f} device kernels per call, bound "
              f"{1e3 * times['bound_ms']:.4f} us ({times['bound_by']}), plain version "
              f"{times['plain_ms']:.3f} ms")
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
        "layouts": ["time_major [T, B] (the recurrent paths' minibatches)",
                    "batch_major [B, T], read in place (every static path's minibatches)"],
        "batch_major": batch_major,
        "design": (f"one launch for every reward key (blockIdx.y), {shipped_columns} columns per "
                   "block, [T, columns] tiles (batch-major: [columns, T], one span of "
                   "columns x T elements) staged by cp.async before the recurrence, flags read "
                   "as bool or float32; batch-major advantages written back through shared "
                   "memory as [B, T] rows"),
        "ptxas": ptxas_row(("gae", ()), "gae_kernelIhh"),
    }


DR_RANGES = dict(
    mass_scale=(0.8, 1.2), friction=(0.4, 1.0), damping_scale=(0.9, 1.1), gain_scale=(0.9, 1.1)
)
ROUGH = dict(seed=2, amplitude=0.03, wavelength=1.5)

# The control-step configurations checked against the plain version:
# name -> (model, batch, exact, full feature set). The quadruped's full set
# is rough terrain, the DR lanes and the push; the humanoid's is self-
# collision and joint limits, and its cases are the held factor at
# humanoid_8192_pallas's 8192 envs and the exact factor with both features
# at humanoid_2048_full's 2048. 33 and 1001 end inside a warp at every
# group size from 2 to 16 lanes per env.
CONTROL_STEP_CASES = {
    "held, full features, B=2048": ("quadruped", 2048, False, True),
    "exact, full features, B=2048": ("quadruped", 2048, True, True),
    "held, flat ground, no extras, B=1000": ("quadruped", 1000, False, False),
    "held, flat ground, no extras, B=2048": ("quadruped", 2048, False, False),
    "held, full features, B=33": ("quadruped", 33, False, True),
    "exact, full features, B=1001": ("quadruped", 1001, True, True),
    "humanoid held, B=8192": ("humanoid", 8192, False, False),
    "humanoid exact, self-collision and joint limits, B=2048": ("humanoid", 2048, True, True),
    "humanoid held, B=33": ("humanoid", 33, False, False),
    "humanoid exact, self-collision and joint limits, B=1001": ("humanoid", 1001, True, True),
    "mjcf_quadruped held, B=2048": ("mjcf_quadruped", 2048, False, False),
    "mjcf_quadruped held, B=33": ("mjcf_quadruped", 33, False, False),
}
# The cases timed beside their bound: the physics leg's shape, the flat
# quadruped's of the bf16-store and distillation paths, and the two
# humanoid paths' (key in the kernels line -> case).
CONTROL_STEP_TIMED = {
    "quadruped": "held, full features, B=2048",
    "quadruped_flat_2048": "held, flat ground, no extras, B=2048",
    "humanoid_held_8192": "humanoid held, B=8192",
    "humanoid_exact_full_2048": "humanoid exact, self-collision and joint limits, B=2048",
    "mjcf_quadruped_2048": "mjcf_quadruped held, B=2048",
}
# The (lanes per env, threads per block) variants of --variants.
CONTROL_STEP_GROUPS, SCENE_STEP_GROUPS = (2, 4, 8, 16), (1, 2, 4, 8)
VARIANT_THREADS = (32, 64, 128, 256)
# Dynamic shared memory a block of the H100 can have.
MAX_BLOCK_SMEM_BYTES = 232448


def control_step_case(name: str, torch, batch: int | None = None):
    """(plan, args on the card) of one control-step configuration, 10
    substeps of 2 ms: the quadruped at kp=60 from states near the standing
    pose with some feet in contact; the humanoid at kp=350 from states near
    the standing pose with some feet on the ground and, in every other env,
    the two feet's spheres pressed together
    (``physics/testing.py::humanoid_states``); the MJCF quadruped at its
    imported kp (60) from states near its crouch (``DEFAULT_POSE`` at
    0.312 m), built from the saved import, with its own sizes (4 ground
    geoms where the native quadruped has 8)."""
    import numpy as np

    from nnx_ppo_tpu_torch.physics.cuda_step import ControlStepPlan
    from nnx_ppo_tpu_torch.physics.models import make_humanoid, mjcf_quadruped
    from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
    from nnx_ppo_tpu_torch.physics.terrain import rough_terrain
    from nnx_ppo_tpu_torch.physics.testing import humanoid_states, standing_states

    model_name, B, exact, full = CONTROL_STEP_CASES[name]
    B = batch or B
    keys = ("qpos", "qvel", "target")
    if model_name == "mjcf_quadruped":
        env = mjcf_quadruped.make_env(reuse_mass_matrix=not exact)
        plan = ControlStepPlan(env.model, env.kp, 0.002, 10, exact)
        pose = np.concatenate([[0.0, 0.0, mjcf_quadruped.STAND_HEIGHT, 1.0, 0.0, 0.0, 0.0],
                               mjcf_quadruped.DEFAULT_POSE])
        arrays = standing_states(env.model, pose, B, seed=3)
    elif model_name == "humanoid":
        model = make_humanoid(self_collision=full, joint_limits=full)
        plan = ControlStepPlan(model, 350.0, 0.002, 10, exact)
        arrays = humanoid_states(model, B, seed=3)
    else:
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
        keys += ("extra",) if full else ()
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
    stiffness amplify rounding). The humanoid is held to the same numbers:
    its PD gain (350 against 60) and contact stiffness (12,000 N/m) are
    stiffer, but what a gap of rounding alone does to it was measured on
    the host (the kernel built by g++ with glibc's sinf, cosf and sqrtf
    against PyTorch's, tests/test_torch_kernel_schedule.py): qvel 2.2e-5,
    normals 4.3e-4 after ten substeps, 90 and 100 times inside. Also
    whether each output is equal to the bit (the kernel repeats the plain
    version's operations in its order)."""
    got = plan.cuda(*args)
    want = plan.plain(*args)
    torch.cuda.synchronize()
    check(bool((want[2] > 0).any() and (want[2] == 0).any()), "some feet touch, some do not")
    n_ground = len(plan.model.geom_body)
    if plan.n_geoms > n_ground:
        check(bool((want[2][:, n_ground:] > 0).any()), "the sphere pairs touch in some envs")
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


def control_step_row(plan, args, torch) -> dict:
    """One timed shape of the control step: the kernel timed three ways
    (:func:`kernel_times`), the plain version's time (one call, after
    count_plain_operations' warm-up on 8 envs: the exact plain version
    rebuilds the factor in every substep), the bytes and counted operations
    per env, the bound, the launch and ptxas's row."""
    model, B = plan.model, args[0].shape[0]
    times = kernel_times(lambda: plan.cuda(*args), "control_step_kernel", torch,
                         n_wrapper=50, n_profile=20, n_graph=20)
    bytes_per_env = 4 * (model.nq + model.nv + model.nj + plan.n_extra
                         + model.nq + model.nv + plan.n_geoms)
    ops_per_env = count_plain_operations(plan.plain, args, torch)
    bound, bound_by = bound_ms(bytes_per_env * B, ops_per_env * B)
    plain_ms = time_ms(lambda: plan.plain(*args), 1, torch, warmup=0)
    return dict(times, shape=[B, model.nq], plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, ops_per_env=ops_per_env, bytes_per_env=bytes_per_env,
                design=launch_design(plan),
                ptxas=ptxas_row(plan.kernel_spec, "control_step_kernel",
                                plan.shared_memory_bytes()))


def control_step_kernel_phase(torch, variants: bool) -> dict:
    """Every case of :data:`CONTROL_STEP_CASES` against the plain version,
    then the shapes of :data:`CONTROL_STEP_TIMED` timed (wrapper by CUDA
    events, device time by the profiler and in a CUDA graph) beside their
    bound, the plain version, ptxas's row and the shared memory per block
    (the humanoid: 11 bodies, nv = 16, one row of the forward solve per
    lane at 16 lanes per env; 6 ground geoms, 0 or 4 pairs; the MJCF
    quadruped: 13 bodies, 4 ground geoms, held to the bit)."""
    from nnx_ppo_tpu_torch.ops import cuda_build
    from nnx_ppo_tpu_torch.physics import cuda_step

    max_err = 0.0
    cases, checked = {}, {}
    for name in CONTROL_STEP_CASES:
        plan, args = control_step_case(name, torch)
        before = cuda_step.control_step_cuda.launches
        errs, equal = control_step_errors(plan, args, torch)
        check(cuda_step.control_step_cuda.launches == before + 1, "the wrapper counted its launch")
        max_err = max(max_err, errs["qpos"], errs["qvel"])
        cases[name] = (plan, args)
        checked[name] = {"errors": errs, "equal": equal}
        print(f"control_step {name}: max_abs_err qpos {errs['qpos']:.3g} (atol 2e-4) "
              f"qvel {errs['qvel']:.3g} (atol 2e-3) normals {errs['normals']:.3g} "
              f"(rtol 5e-3, atol 5e-2); {describe_equal(equal)}")
        if CONTROL_STEP_CASES[name][0] == "mjcf_quadruped":
            # A third model's -D sizes: held to the plain version to the bit.
            check(all(equal.values()), f"control_step {name}: torch.equal with the plain version")
    rows = {}
    for label, name in CONTROL_STEP_TIMED.items():
        rows[label] = row = control_step_row(*cases[name], torch)
        print(f"control_step {name}: wrapper {1e3 * row['wrapper_ms']:.2f} us, kernel "
              f"{1e3 * row['kernel_device_ms']:.2f} us (profiler), {1e3 * row['graph_ms']:.2f} us "
              f"(CUDA graph); plain {row['plain_ms']:.2f} ms; {row['bytes_per_env']} bytes and "
              f"{row['ops_per_env']:.0f} float operations per env, bound "
              f"{1e3 * row['bound_ms']:.3f} us ({row['bound_by']}); {row['design']}; ptxas "
              f"{row['ptxas']}")
    # The exact mode at the physics leg's shape.
    exact_plan, exact_args = cases["exact, full features, B=2048"]
    exact_ms = time_ms(lambda: exact_plan.cuda(*exact_args), 20, torch)
    print(f"control_step exact, full features, B=2048: {exact_ms:.4f} ms (CUDA events)")
    quadruped = rows.pop("quadruped")
    result = dict(
        quadruped,
        name="control_step",
        route="cuda",
        source="nnx_ppo_tpu_torch/csrc/control_step.cu",
        replaces="nnx_ppo_tpu/physics/pallas_step.py:330",
        launches=None,
        max_abs_err=max_err,
        ms=quadruped["wrapper_ms"],
        library_ms=None,  # no single PyTorch call computes a control step
        exact_ms=exact_ms,
        cases=checked,
        at_other_shapes=rows,
    )
    plan, args = cases[CONTROL_STEP_TIMED["quadruped"]]
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


def plane_sampler_case(name: str, torch, batch: int | None = None):
    """(plan, qpos on the card) of one sampler configuration: standing
    quadrupeds spread over the spawn radius, at the local ground height."""
    from nnx_ppo_tpu_torch.physics.cuda_step import ControlStepPlan
    from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
    from nnx_ppo_tpu_torch.physics.terrain import rough_terrain
    from nnx_ppo_tpu_torch.physics.testing import standing_states

    B, n, extent = PLANE_SAMPLER_CASES[name]
    B = batch or B
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


def scene_step_case(name: str, torch, batch: int | None = None):
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
    B = batch or B
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


def humanoid_leg(torch):
    """humanoid_8192_pallas (benchmarks/suite.py:570): the humanoid on
    flat ground, held factor, no randomization, terrain or push, 8192
    envs, T=20, the physics leg's net (proprio 36), combined advantages;
    one control-step launch per env step at the humanoid's sizes."""
    from nnx_ppo_tpu_torch.envs import HumanoidJoystick

    env, networks, config, optimizer = quadruped_leg(
        torch, HumanoidJoystick(reuse_mass_matrix=True))
    return env, networks, dataclasses.replace(config, n_envs=8192), optimizer


def humanoid_full_leg(torch):
    """humanoid_2048_full (benchmarks/suite.py:458): the humanoid with the
    foot self-collision pairs and joint limits, the factor rebuilt at every
    substep (exact), 2048 envs, T=20."""
    from nnx_ppo_tpu_torch.envs import HumanoidJoystick

    return quadruped_leg(torch, HumanoidJoystick(self_collision=True, joint_limits=True))


def locomotion_leg(torch):
    """locomotion_4096 (benchmarks/suite.py:132): the analytic joystick
    task (dict obs, dict reward), 500-step limit, the Concat encoder
    (proprio 128, command 32), actor 128, two critic heads, 4096 envs,
    T=20, combined advantages; no physics kernel."""
    from nnx_ppo_tpu_torch.envs import JoystickLocomotion

    env, networks, config, optimizer = quadruped_leg(torch, JoystickLocomotion())
    return env, networks, dataclasses.replace(config, n_envs=4096), optimizer


def heavy_physics_leg(torch):
    """heavy_physics_8192 (benchmarks/suite.py:158): NLinkSwingup with 5
    links (a 5 x 5 mass matrix and its Cholesky solve per env and
    substep, 4 substeps), 500-step limit, MLP actor 256x2, critic 256x2,
    8192 envs, T=20; no physics kernel."""
    from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
    from nnx_ppo_tpu_torch.envs import NLinkSwingup
    from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    env = EpisodeWrapper(NLinkSwingup(n_links=5), max_len=500)
    networks = make_mlp_actor_critic(
        env.observation_size, env.action_size, [256, 256], [256, 256], 0, entropy_weight=1e-3,
    )
    config = PPOConfig(n_envs=8192, rollout_length=20)
    return env, networks, config, make_optimizer(config.learning_rate)


def gru_leg(torch, fused_replay: bool = True):
    """cartpole_gru (benchmarks/suite.py:83-105): actor GRU(obs, 64) ->
    Dense(64, 2A) -> NormalTanhSampler, critic GRU(obs, 64) -> Dense(64, 1),
    no obs normalization; 500-step limit, 1024 envs, T=30, 4 x 4 minibatches.
    The fused replay hoists each GRU's input projection; ``fused_replay=
    False`` replays the whole net step by step."""
    from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
    from nnx_ppo_tpu_torch.envs import CartpoleBalance
    from nnx_ppo_tpu_torch.networks import GRU, Dense, NormalTanhSampler, PPOAdapter, Sequential
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    env = EpisodeWrapper(CartpoleBalance(), max_len=500)
    obs, n_act = env.observation_size, env.action_size
    g = torch.Generator().manual_seed(0)
    actor = Sequential.create([
        GRU.create(obs, 64, g), Dense.create(64, 2 * n_act, g),
        NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    critic = Sequential.create([GRU.create(obs, 64, g), Dense.create(64, 1, g)])
    networks = PPOAdapter.create(action=actor, value=critic)
    config = PPOConfig(n_envs=1024, rollout_length=30, fused_replay=fused_replay)
    return env, networks, config, make_optimizer(config.learning_rate)


def gru_unfused_leg(torch):
    return gru_leg(torch, fused_replay=False)


def lstm_leg(torch):
    """The GRU path's net with LSTM cells (no suite row; for the loss
    reference only)."""
    from nnx_ppo_tpu_torch.networks import LSTM, Dense, NormalTanhSampler, PPOAdapter, Sequential

    env, _, config, optimizer = gru_leg(torch)
    obs, n_act = env.observation_size, env.action_size
    g = torch.Generator().manual_seed(1)
    actor = Sequential.create([
        LSTM.create(obs, 64, g), Dense.create(64, 2 * n_act, g),
        NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    critic = Sequential.create([LSTM.create(obs, 64, g), Dense.create(64, 1, g)])
    return env, PPOAdapter.create(action=actor, value=critic), config, optimizer


def delay_ar1_leg(torch):
    """An actor Dense(obs, 4A) -> Delay(k=2) -> AR1VariationalBottleneck(2A)
    -> NormalTanhSampler, critic MLP 64; the GRU path's env and config
    (for the loss reference only)."""
    from nnx_ppo_tpu_torch.networks import (
        AR1VariationalBottleneck, Delay, Dense, NormalTanhSampler, PPOAdapter, Sequential, make_mlp,
    )

    env, _, config, optimizer = gru_leg(torch)
    obs, n_act = env.observation_size, env.action_size
    g = torch.Generator().manual_seed(2)
    actor = Sequential.create([
        Dense.create(obs, 4 * n_act, g, torch.tanh),
        Delay.create(torch.zeros(4 * n_act), k_steps=2),
        AR1VariationalBottleneck.create(2 * n_act, kl_weight=1e-3, ar1_weight=1e-2),
        NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    critic = make_mlp([obs, 64, 1], g, activation_last_layer=False)
    return env, PPOAdapter.create(action=actor, value=critic), config, optimizer


def population_graph_leg(torch):
    """population_graph (benchmarks/suite.py:320-349): sensor -> core(64,
    tanh) with a delay-1 self-loop -> motor, as Filter / graph / Filter /
    Flattener / NormalTanhSampler, critic MLP 256; 1024 envs, T=30."""
    from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
    from nnx_ppo_tpu_torch.envs import CartpoleBalance
    from nnx_ppo_tpu_torch.networks import (
        Filter, Flattener, NormalTanhSampler, PPOAdapter, Sequential, make_mlp,
    )
    from nnx_ppo_tpu_torch.networks.graph import PopulationGraph
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    env = EpisodeWrapper(CartpoleBalance(), max_len=500)
    b = PopulationGraph.builder(3)
    b.add_input("sensor", env.observation_size, input_from="obs")
    b.add_population("core", 64, activation=torch.tanh)
    b.add_output("motor", 2 * env.action_size)
    b.connect("sensor", "core")
    b.connect("core", "core", delay=1)
    b.connect("core", "motor")
    actor = Sequential.create([
        Filter.create({"obs": lambda x: x}), b.finalize(), Filter.create({"motor": "motor"}),
        Flattener.create(), NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    critic = make_mlp([env.observation_size, 256, 1], torch.Generator().manual_seed(4),
                      activation_last_layer=False)
    networks = PPOAdapter.create(action=actor, value=critic)
    config = PPOConfig(n_envs=1024, rollout_length=30)
    return env, networks, config, make_optimizer(config.learning_rate)


def mlp_wide_bf16_leg(torch):
    """mlp_wide_bf16_8192 (benchmarks/suite.py:69-80): make_mlp_actor_critic
    with actor 1024 x 4, critic 2048 x 2, compute_dtype bf16 (the float32
    product of bf16-rounded operands), obs normalization; 500-step limit,
    8192 envs, T=20."""
    from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer
    from nnx_ppo_tpu_torch.envs import CartpoleBalance
    from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    env = EpisodeWrapper(CartpoleBalance(), max_len=500)
    networks = make_mlp_actor_critic(
        env.observation_size, env.action_size, [1024] * 4, [2048] * 2, 0, entropy_weight=1e-3,
        compute_dtype="bfloat16",
    )
    config = PPOConfig(n_envs=8192, rollout_length=20)
    return env, networks, config, make_optimizer(config.learning_rate)


# The networks paths: label -> (leg, checked steps, timed steps).
NETWORK_PATHS = {
    "gru_1024": (gru_leg, 1, 3),
    "gru_1024_unfused": (gru_unfused_leg, 1, 1),
    "population_graph_1024": (population_graph_leg, 1, 3),
    "mlp_wide_bf16_8192": (mlp_wide_bf16_leg, 1, 3),
}


def bf16store_leg(torch):
    """quadruped_2048_pallas_bf16store (benchmarks/suite.py:548-551): the
    quadruped on flat ground (held factor, no randomization, no pushes),
    the physics leg's net (no Normalizer) and config with
    replay_store_dtype="bfloat16": the replay view keeps its float obs
    leaves in bf16, transposed to batch-major ("auto") in the same copy."""
    from nnx_ppo_tpu_torch.envs import QuadrupedJoystick

    env, networks, config, optimizer = quadruped_leg(
        torch, QuadrupedJoystick(reuse_mass_matrix=True))
    return env, networks, dataclasses.replace(config, replay_store_dtype="bfloat16"), optimizer


def mjcf_quadruped_leg(torch):
    """mjcf_quadruped_2048 (benchmarks/suite.py:577-582): the MJCF quadruped
    (examples/mjcf_import.py's XML) from its saved import through
    legged_from_import: kp 60 and per-joint action scales from the position
    actuators, the crouch DEFAULT_POSE at 0.312 m, held factor, flat
    ground; the physics leg's net and config (2048 envs, T=20, 4 x 4
    minibatches). One control-step launch per env step at the imported
    model's sizes."""
    from nnx_ppo_tpu_torch.physics.models.mjcf_quadruped import make_env

    return quadruped_leg(torch, make_env(reuse_mass_matrix=True))


def generic_quadruped_leg(torch):
    """quadruped_2048_fastM_generic (benchmarks/suite.py:427-430): the
    quadruped with the held factor on the generic engine
    (substep_impl="xla", depthwise=False), flat ground, no randomization or
    pushes; the physics leg's net and config. Eager PyTorch on the card: no
    physics kernel, GAE only."""
    from nnx_ppo_tpu_torch.envs import QuadrupedJoystick

    return quadruped_leg(torch, QuadrupedJoystick(
        reuse_mass_matrix=True, depthwise=False, substep_impl="xla"))


def distill_leg(torch, shuffle: bool = True):
    """distill_quadruped_2048 and _noshuffle (benchmarks/suite.py:708-743):
    the bf16-store path's env and net as the teacher, in eval mode; the
    student the same net with each float32 parameter shifted by 0.01 *
    sign(sin(arange(size))) in its [in, out] order (the JAX layout the
    port keeps); DistillationConfig(n_envs=2048, rollout_length=20) with
    its defaults (lr 1e-4, 4 x 4 minibatches), shuffled or contiguous."""
    from nnx_ppo_tpu_torch.algorithms import DistillationConfig, make_optimizer
    from nnx_ppo_tpu_torch.envs import QuadrupedJoystick

    env, teacher, _, _ = quadruped_leg(torch, QuadrupedJoystick(reuse_mass_matrix=True))
    student = copy.deepcopy(teacher)
    with torch.no_grad():
        for p in student.parameters():
            shift = torch.sign(torch.sin(torch.arange(p.numel(), dtype=torch.float32)))
            p.add_(0.01 * shift.reshape(p.shape))
    config = DistillationConfig(n_envs=2048, rollout_length=20, shuffle_minibatches=shuffle)
    return env, teacher.eval(), student, config, make_optimizer(config.learning_rate)


# label -> (shuffled minibatches, checked steps, timed steps).
DISTILL_PATHS = {
    "distill_quadruped_2048": (True, 2, 3),
    "distill_quadruped_2048_noshuffle": (False, 1, 2),
}


def on_device(tree, device):
    """``tree`` with its tensors on ``device`` (a view's layout flag
    passes through)."""
    from nnx_ppo_tpu_torch.core.struct import tree_map

    return tree_map(lambda x: x.to(device) if hasattr(x, "to") else x, tree)


def first_envs(torch, view, width: int):
    """The minibatch of ``view``'s first ``width`` envs, gathered by the
    extractors that ``minibatch_plan`` gives for the view's layout."""
    from nnx_ppo_tpu_torch.parallel.permutation import minibatch_plan

    selectors, take_seq, take_batch = minibatch_plan(
        width, 1, 1, selectors=torch.arange(width, device="cuda")[None],
        batch_major=view.batch_major)
    return view.gather(selectors[0], take_seq, take_batch)


def dense_tflop_per_step(networks, config) -> float:
    """TFLOP of the Dense matmuls in one ``ppo_step``: 2 * in * out per
    sample and layer forward, over the rollout's T * B samples once, the
    update's E epochs of T * B samples forward and backward (three
    matmuls of that size: the forward, the input's gradient and the
    kernel's), and the E * M bootstrap forwards of B / M samples."""
    from nnx_ppo_tpu_torch.networks import Dense

    per_sample = sum(2 * m.kernel.shape[0] * m.kernel.shape[1]
                     for m in networks.modules() if isinstance(m, Dense))
    samples = config.n_envs * config.rollout_length
    passes = samples + 3 * config.n_epochs * samples + config.n_epochs * config.n_envs
    return per_sample * passes / 1e12


def check_finite(history: dict, torch) -> None:
    for name, v in history.items():
        check(bool(torch.isfinite(torch.as_tensor(v)).all()), f"{name} is finite")


def profile_step(torch, step, step_ms: float, profile_dir: str, label: str):
    """One profiled training step (``step()``, a ppo_step or a
    distillation_step, returns the next state): kernels per step, device
    busy time, idle share, and the share of each hand-written kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts = step()
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


def step_device_profile(torch, step, step_ms: float, label: str):
    """One training step (``step()`` returns the next state) under
    torch.profiler, device activity only: device kernels per step, device
    busy ms (their summed device time) and the device's idle share against
    the unprofiled step time ``step_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ts = step()
        torch.cuda.synchronize()
    device_events = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in device_events) / 1e3
    out = {"device_kernels": sum(e.count for e in device_events), "busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / step_ms}
    print(f"{label}: {out['device_kernels']} device kernels per ppo_step, device busy "
          f"{busy_ms:.2f} ms of the unprofiled {step_ms:.2f} ms step, idle share "
          f"{out['idle_share']:.3f}")
    return ts, out


def print_layout(label: str, config, networks) -> str:
    """The replay layout ``config.rollout_layout`` resolves to for
    ``networks`` (and the store dtype), printed; returns the layout."""
    from nnx_ppo_tpu_torch.algorithms import resolve_batch_major

    layout = "batch_major" if resolve_batch_major(config, networks) else "time_major"
    print(f"{label}: rollout_layout {config.rollout_layout!r} resolves to {layout}, "
          f"replay_store_dtype {config.replay_store_dtype}")
    return layout


def flagship_path_phase(torch, kernels: list, profile_dir: str | None) -> dict:
    from nnx_ppo_tpu_torch.algorithms import new_training_state, ppo_multi_step, ppo_step
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda

    env, networks, config, optimizer = flagship(torch)
    per_step = config.n_envs * config.rollout_length
    updates = config.n_epochs * config.n_minibatches
    layout = print_layout("flagship", config, networks)

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
        ts = profile_step(torch, lambda: ppo_step(env, ts, config, optimizer)[0], step_ms,
                          profile_dir, "flagship")
    return {
        "layout": layout,
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
    from nnx_ppo_tpu_torch.algorithms import new_training_state, ppo_multi_step, ppo_step

    env, networks, config, optimizer = leg(torch)
    per_env_steps = config.n_envs * config.rollout_length
    layout = print_layout(label, config, networks)

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
        check(obs["proprio"].shape == (config.n_envs, env.observation_size["proprio"]),
              "proprio obs shape")
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
        ts = profile_step(torch, lambda: ppo_step(env, ts, config, optimizer)[0], step_ms,
                          profile_dir, label)
    result.update({
        "layout": layout,
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


def distill_path_phase(torch, kernels: list, profile_dir: str | None, label: str, shuffle: bool,
                       n_checked: int, n_timed: int, per_step: dict) -> dict:
    """A distillation path at full width through new_distillation_state
    and distillation_multi_step, every kernel's count set to 0 just
    before and read just after: ``n_checked`` checked, then ``n_timed``
    timed steps. The teacher's parameters must come out unchanged to the
    bit, and the student's moved."""
    from nnx_ppo_tpu_torch.algorithms import (
        distillation_multi_step, distillation_step, new_distillation_state,
    )

    env, teacher, student, config, optimizer = distill_leg(torch, shuffle)
    teacher = teacher.to("cuda")
    layout = print_layout(label, config, student)
    per_env_steps = config.n_envs * config.rollout_length

    def check_counts(n_steps: int) -> None:
        for k in kernels:
            check(k.launches == per_step[k.__name__] * n_steps,
                  f"{label}: {k.__name__} launches {k.launches} after {n_steps} steps")

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = new_distillation_state(env, teacher, student, config.n_envs, seed=0,
                                   optimizer=optimizer, device="cuda")
    teacher_before = [p.detach().clone() for p in teacher.parameters()]
    student_before = [p.detach().clone() for p in state.student.parameters()]
    state, metrics = distillation_multi_step(env, teacher, state, config, optimizer, n_checked)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(state.steps_taken == n_checked * per_env_steps, f"steps_taken {state.steps_taken}")
    check_counts(n_checked)
    check_finite(metrics, torch)
    nll_first = float(metrics["losses/distillation_nll/mean"])

    t0 = time.perf_counter()
    state, metrics = distillation_multi_step(env, teacher, state, config, optimizer, n_timed)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    n_steps = n_checked + n_timed
    check_counts(n_steps)
    check_finite(metrics, torch)
    launches = {k.__name__: k.launches for k in kernels}
    check(state.steps_taken == n_steps * per_env_steps, f"steps_taken {state.steps_taken}")
    check(all(torch.equal(a, p) for a, p in zip(teacher_before, teacher.parameters())),
          f"{label}: the teacher's parameters are unchanged")
    check(not all(torch.equal(a, p) for a, p in zip(student_before, state.student.parameters())),
          f"{label}: the student's parameters moved")
    step_ms = timed_s / n_timed * 1e3
    if profile_dir:
        state = profile_step(
            torch, lambda: distillation_step(env, teacher, state, config, optimizer)[0], step_ms,
            profile_dir, label)
    return {
        "layout": layout,
        "launches": launches,
        "n_steps": n_steps,
        "first_call_s": first_s,
        "step_ms": step_ms,
        "sps": n_timed * per_env_steps / timed_s,
        "state": state,
        "env": env,
        "config": config,
        "teacher": teacher,
        "nll": [nll_first, float(metrics["losses/distillation_nll/mean"])],
    }


def share_of_limit(got, want, rtol: float, atol: float) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)``: 1 is the limit."""
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def shares_of_limit(loss, grads, loss_want, grads_want, lim: dict) -> tuple[float, float]:
    """(loss share, largest gradient share) of ``lim``'s tolerances: above
    1 a check fails."""
    loss_share = abs(loss - loss_want) / (lim["loss_atol"] + lim["loss_rtol"] * abs(loss_want))
    grad_share = max(share_of_limit(g.cpu(), w.cpu(), lim["grad_rtol"], lim["grad_atol"])
                     for g, w in zip(grads, grads_want))
    return loss_share, grad_share


def layout_reference_phase(torch, label: str, env, config, ts) -> None:
    """The PPO loss and gradients of one full-width minibatch of a fresh
    rollout on the card, batch-major (GAE reads the minibatch's [b, T]
    keys in place) against time-major, at ``LOSS_LIMITS``: the same
    function, its float32 sums associated differently. Printed beside
    what the batch-major loss reads with one GAE column wrong (env 0's
    advantages taken from env 1)."""
    from nnx_ppo_tpu_torch.algorithms import ppo as ppo_module
    from nnx_ppo_tpu_torch.algorithms import ppo_loss
    from nnx_ppo_tpu_torch.algorithms.ppo import ReplayMinibatch
    from nnx_ppo_tpu_torch.algorithms.rollout import unroll_env
    from nnx_ppo_tpu_torch.core.struct import tree_map

    net = ts.networks
    with torch.no_grad():
        _, _, rollout = unroll_env(env, ts.env_states, net, ts.network_states,
                                   config.rollout_length, ts.generator)
    width = config.n_envs // config.n_minibatches
    states = tree_map(lambda x: x[:width], ts.network_states)

    def loss_and_grads(batch_major: bool):
        view = first_envs(torch, ReplayMinibatch.from_rollout(rollout, batch_major), width)
        net.zero_grad(set_to_none=True)
        loss, _ = ppo_loss(
            net, states, view, clip_range=config.clip_range, normalize_advantages=True,
            combine_advantages=config.combine_advantages,
            discounting_factor=config.discounting_factor, gae_lambda=config.gae_lambda,
            critic_loss_weight=1.0, logging_level=config.logging_level,
            fused_replay=config.fused_replay,
        )
        loss.backward()
        return loss.item(), [p.grad.clone() for p in net.parameters()]

    loss_tm, grads_tm = loss_and_grads(False)
    loss_bm, grads_bm = loss_and_grads(True)
    shipped = ppo_module.gae_per_key

    def one_column_wrong(*args, **kwargs):
        def wrong(a):
            a = a.clone()
            a[0] = a[1]
            return a
        return tree_map(wrong, shipped(*args, **kwargs))

    try:
        ppo_module.gae_per_key = one_column_wrong
        loss_wrong, grads_wrong = loss_and_grads(True)
    finally:
        ppo_module.gae_per_key = shipped
    net.zero_grad(set_to_none=True)
    lim = LOSS_LIMITS
    share = shares_of_limit(loss_bm, grads_bm, loss_tm, grads_tm, lim)
    wrong = shares_of_limit(loss_wrong, grads_wrong, loss_tm, grads_tm, lim)
    print(f"layout reference {label}: loss batch-major {loss_bm:.6f} time-major {loss_tm:.6f}; "
          f"share of the limit (loss rtol {lim['loss_rtol']:g} atol {lim['loss_atol']:g}, "
          f"gradients rtol {lim['grad_rtol']:g} atol {lim['grad_atol']:g}): loss {share[0]:.3g}, "
          f"gradients {share[1]:.3g}; one GAE column of {width} wrong would read loss "
          f"{wrong[0]:.3g}, gradients {wrong[1]:.3g}")
    check(share[0] <= 1.0 and share[1] <= 1.0,
          f"{label}: batch-major and time-major losses agree within LOSS_LIMITS")


def bf16_store_equality_phase(torch) -> None:
    """On a bf16-compute net without obs normalization (the flagship's env
    and widths with compute_dtype bf16, 1024 envs, T=30), the bf16 replay
    store is exact: the net rounds its obs to bf16 itself. The loss and
    every gradient of one batch-major minibatch on the card with the bf16
    store torch.equal the float32 store's."""
    from nnx_ppo_tpu_torch.algorithms import LoggingLevel, ppo_loss
    from nnx_ppo_tpu_torch.algorithms.ppo import ReplayMinibatch
    from nnx_ppo_tpu_torch.algorithms.rollout import unroll_env
    from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic

    env, _, config, _ = flagship(torch)
    net = make_mlp_actor_critic(
        env.observation_size, env.action_size, [64] * 4, [256] * 2, 0, normalize_obs=False,
        entropy_weight=1e-3, compute_dtype=torch.bfloat16,
    ).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    state = net.initialize_state(config.n_envs)
    with torch.no_grad():
        _, _, rollout = unroll_env(env, env.reset(config.n_envs, g), net, state,
                                   config.rollout_length, g)
    width = config.n_envs // config.n_minibatches
    results = []
    for store in (None, torch.bfloat16):
        view = first_envs(torch, ReplayMinibatch.from_rollout(rollout, True, store), width)
        net.zero_grad(set_to_none=True)
        loss, _ = ppo_loss(net, net.initialize_state(width), view, clip_range=0.2,
                           normalize_advantages=True,
                           combine_advantages=False, discounting_factor=0.99, gae_lambda=0.95,
                           critic_loss_weight=1.0, logging_level=LoggingLevel.NONE)
        loss.backward()
        results.append((loss.detach(), [p.grad.clone() for p in net.parameters()], view))
    (loss_a, grads_a, _), (loss_b, grads_b, view_b) = results
    check(view_b.obs.dtype == torch.bfloat16, "the bf16 store keeps the obs in bf16")
    same = bool(torch.equal(loss_a, loss_b)) and all(torch.equal(a, b)
                                                      for a, b in zip(grads_a, grads_b))
    print(f"bf16 store on a bf16-compute net without normalization ([{width}, "
          f"{config.rollout_length}] batch-major minibatch): loss {loss_a.item():.6f} and "
          f"{len(grads_a)} gradients torch.equal to the float32 store's: {same}")
    check(same, "the bf16 store is exact on a bf16-compute net without normalization")


def distillation_reference_phase(torch, label: str, path: dict) -> None:
    """distillation_loss and its gradients for one full-width minibatch of
    a fresh dual rollout on the card (the student's layout) against the
    CPU, at ``LOSS_LIMITS``; printed beside what the loss reads on the CPU
    with one env's teacher extras taken from its neighbour (a rollout that
    stored one env's target wrongly)."""
    from nnx_ppo_tpu_torch.algorithms import LoggingLevel, distillation_loss
    from nnx_ppo_tpu_torch.algorithms.distillation import (
        DistillationMinibatch, distillation_unroll_env,
    )
    from nnx_ppo_tpu_torch.core.struct import tree_map

    state, teacher, config, env = path["state"], path["teacher"], path["config"], path["env"]
    student = state.student
    with torch.no_grad():
        _, _, _, rollout = distillation_unroll_env(
            env, state.env_states, teacher, student, state.student_states, state.teacher_states,
            config.rollout_length, state.generator)
    width = config.n_envs // config.n_minibatches
    batch_major = path["layout"] == "batch_major"
    view = first_envs(torch, DistillationMinibatch.from_rollout(rollout, batch_major), width)
    states = tree_map(lambda x: x[:width], state.student_states)

    def loss_and_grads(net, view, states):
        net.zero_grad(set_to_none=True)
        loss, _ = distillation_loss(net, states, view, LoggingLevel.NONE,
                                    fused_replay=config.fused_replay)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for p in net.parameters()]
        net.zero_grad(set_to_none=True)
        return loss.item(), grads

    t0 = time.perf_counter()
    loss_gpu, grads_gpu = loss_and_grads(student, view, states)
    net_cpu = copy.deepcopy(student).cpu()
    view_cpu, states_cpu = on_device(view, "cpu"), on_device(states, "cpu")
    loss_cpu, grads_cpu = loss_and_grads(net_cpu, view_cpu, states_cpu)

    def one_env_wrong(x):
        x = x.clone()
        if batch_major:
            x[0] = x[1]
        else:
            x[:, 0] = x[:, 1]
        return x

    view_wrong = dataclasses.replace(
        view_cpu, teacher_rollout_extras=tree_map(one_env_wrong, view_cpu.teacher_rollout_extras))
    loss_wrong, grads_wrong = loss_and_grads(net_cpu, view_wrong, states_cpu)
    lim = LOSS_LIMITS
    share = shares_of_limit(loss_gpu, grads_gpu, loss_cpu, grads_cpu, lim)
    wrong = shares_of_limit(loss_wrong, grads_wrong, loss_cpu, grads_cpu, lim)
    print(f"distillation reference {label} ({path['layout']} minibatch of {width}): loss cuda "
          f"{loss_gpu:.6f} cpu {loss_cpu:.6f}; share of the limit (loss rtol {lim['loss_rtol']:g} "
          f"atol {lim['loss_atol']:g}, gradients rtol {lim['grad_rtol']:g} atol "
          f"{lim['grad_atol']:g}): loss {share[0]:.3g}, gradients {share[1]:.3g}; one env's teacher "
          f"extras wrong on the CPU would read loss {wrong[0]:.3g}, gradients {wrong[1]:.3g} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(share[0] <= 1.0 and share[1] <= 1.0,
          f"{label}: the distillation loss on the card is within its limits")


def loss_reference_phase(torch, label: str, env, config, ts, scaled_grad_atol: bool = False,
                         limits: dict | None = None, width: int | None = None,
                         float64_witness: bool = False) -> float:
    """Loss and gradients on the card (one GAE launch for all reward keys)
    against the CPU (plain GAE) for one full-width minibatch of a fresh
    rollout, and against the card's loss with one GAE launch per key (the
    calls that gae_per_key replaced): the same bits. Gradients: rtol 1e-3,
    atol 1e-5; with ``scaled_grad_atol`` the atol is 1e-5 times the
    tensor's largest entry where that exceeds 1: float32 sums over T *
    width samples in another order differ by a share of the summands'
    size, not of the result's, so an entry near 0 in a tensor of entries
    above 1 misses a fixed 1e-5 (the full humanoid's actor head: 1.45e-5
    on an entry of 2e-5). ``limits`` replaces the default tolerances
    (``LOSS_LIMITS``) for a path whose arithmetic differs more between the
    devices (bf16 compute). The loss replays as ``config.fused_replay``
    says. The errors are printed, each as its share of its limit, before
    they are checked. ``width`` narrows the minibatch (default: the
    path's, ``n_envs // n_minibatches``) where the CPU's half would take
    long. The minibatch has the layout and store dtype the path's config
    resolves to (batch-major: GAE reads its [b, T] keys in place). With
    ``float64_witness`` the CPU also computes the loss in float64 (net,
    carries and the view's float leaves widened), and the shares of the
    card's and the CPU's float32 gradients against it are printed, at the
    fixed and at the scaled atol: how far float32 on either device lies
    from the function it rounds, beside how far the two lie apart."""
    from nnx_ppo_tpu_torch.algorithms import ppo as ppo_module
    from nnx_ppo_tpu_torch.algorithms import ppo_loss, resolve_batch_major, resolve_store_dtype
    from nnx_ppo_tpu_torch.algorithms.ppo import ReplayMinibatch
    from nnx_ppo_tpu_torch.algorithms.rollout import unroll_env
    from nnx_ppo_tpu_torch.core.struct import tree_map
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda

    net_gpu = ts.networks
    with torch.no_grad():
        _, _, rollout = unroll_env(
            env, ts.env_states, net_gpu, ts.network_states, config.rollout_length, ts.generator
        )
    t0 = time.perf_counter()
    width = width or config.n_envs // config.n_minibatches
    batch_major = resolve_batch_major(config, net_gpu)
    view = first_envs(torch, ReplayMinibatch.from_rollout(rollout, batch_major,
                                                          resolve_store_dtype(config)), width)
    kw = dict(
        clip_range=config.clip_range,
        normalize_advantages=True,
        combine_advantages=config.combine_advantages,
        discounting_factor=config.discounting_factor,
        gae_lambda=config.gae_lambda,
        critic_loss_weight=1.0,
        logging_level=config.logging_level,
        fused_replay=config.fused_replay,
    )
    lim = dict(LOSS_LIMITS, **(limits or {}))

    def widened(tree):
        return tree_map(lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point()
                        else x, tree)

    def cpu_loss(net, view_cpu, widen=False):
        states = tree_map(lambda x: x[:width].cpu(), ts.network_states)
        loss, _ = ppo_loss(net, widened(states) if widen else states, view_cpu, **kw)
        loss.backward()
        return loss

    net_cpu = copy.deepcopy(net_gpu).cpu()
    view_cpu = on_device(view, "cpu")
    before = gae_cuda.launches
    net_gpu.zero_grad(set_to_none=True)
    loss_gpu, _ = ppo_loss(net_gpu, tree_map(lambda x: x[:width], ts.network_states), view, **kw)
    loss_gpu.backward()
    check(gae_cuda.launches == before + 1, "the loss on the card launched the GAE kernel once")
    loss_cpu = cpu_loss(net_cpu, view_cpu)
    want_grads = [p.grad for p in net_cpu.parameters()]

    worst: dict = {}

    def grad_share(got_grads, scaled: bool = scaled_grad_atol, wants=None) -> float:
        """The largest |got - want| / (atol + rtol |want|) over every
        gradient entry (``wants``: the reference's gradients by default):
        above 1 the check fails. The worst entry is kept in ``worst``
        (tensor, |got - want|, |want|, the tensor's largest |want|) for
        the print."""
        share = 0.0
        for i, (got, want) in enumerate(zip(got_grads, wants or want_grads)):
            largest = want.abs().max().item()
            atol = (lim["grad_atol"] * (max(1.0, largest) if scaled else 1.0)
                    + lim["grad_of_max"] * largest)
            diff = (got.cpu() - want).abs()
            ratio = diff / (atol + lim["grad_rtol"] * want.abs())
            if ratio.max().item() > share:
                share = ratio.max().item()
                j = int(ratio.argmax())
                worst.update(tensor=i, shape=tuple(want.shape), diff=diff.flatten()[j].item(),
                             want=want.flatten()[j].item(), largest=largest)
        return share

    def loss_share(loss, want=None) -> float:
        want = (loss_cpu if want is None else want).item()
        return abs(loss.item() - want) / (lim["loss_atol"] + lim["loss_rtol"] * abs(want))

    max_rel = max_grad = 0.0
    for p_gpu, p_cpu in zip(net_gpu.parameters(), net_cpu.parameters()):
        largest = p_cpu.grad.abs().max().item()
        max_rel = max(max_rel, (p_gpu.grad.cpu() - p_cpu.grad).abs().max().item() / max(largest, 1e-12))
        max_grad = max(max_grad, largest)
    grads = [p.grad for p in net_gpu.parameters()]
    fixed_share = grad_share(grads, scaled=False)
    share = grad_share(grads)
    worst_entry = dict(worst)
    witness = ""
    if float64_witness:
        net_64 = copy.deepcopy(net_gpu).cpu()
        net_64.zero_grad(set_to_none=True)
        loss_64 = cpu_loss(net_64.double(), widened(view_cpu), widen=True)
        grads_64 = [p.grad for p in net_64.parameters()]

        def against_64(got_loss, got_grads) -> str:
            return (f"loss {loss_share(got_loss, loss_64):.3g}, gradients "
                    f"{grad_share(got_grads, scaled=False, wants=grads_64):.3g} (scaled atol "
                    f"{grad_share(got_grads, scaled=True, wants=grads_64):.3g})")

        witness = (f"; float64 witness, share of the limit against float64 on the CPU: the card "
                   f"{against_64(loss_gpu, grads)}, the CPU's float32 "
                   f"{against_64(loss_cpu, want_grads)}")
    of_max = f" + {lim['grad_of_max']:g} x max |grad|" if lim["grad_of_max"] else ""
    print(f"reference {label} ({'batch' if batch_major else 'time'}-major minibatch, "
          f"{config.replay_store_dtype} store): loss cuda {loss_gpu.item():.6f} cpu "
          f"{loss_cpu.item():.6f}, "
          f"worst gradient entry {worst_entry}, "
          f"|diff| {abs(loss_gpu.item() - loss_cpu.item()):.3g}; max grad diff / max |grad| "
          f"{max_rel:.3g}; share of the limit (loss rtol {lim['loss_rtol']:g} atol "
          f"{lim['loss_atol']:g}, gradients rtol {lim['grad_rtol']:g} atol {lim['grad_atol']:g}"
          f"{' x max(1, max |grad|)' if scaled_grad_atol else ''}{of_max}): loss "
          f"{loss_share(loss_gpu):.3g}, gradients {share:.3g}"
          + (f" (against the unscaled atol {fixed_share:.3g})" if scaled_grad_atol else "")
          + witness)
    check(loss_share(loss_gpu) <= 1.0, f"{label}: the loss on the card is within its limit")
    check(share <= 1.0, f"{label}: the gradients on the card are within their limit")
    net_gpu.zero_grad(set_to_none=True)

    # What a wrong GAE reads against the same limits: the CPU loss again,
    # with one of the width columns of every key's advantages taken from
    # its neighbour (a kernel that indexed one column wrongly).
    shipped = ppo_module.gae_per_key

    def one_column_wrong(*args, **kwargs):
        def wrong(a):
            a = a.clone()
            if batch_major:
                a[0] = a[1]
            else:
                a[:, 0] = a[:, 1]
            return a
        return tree_map(wrong, shipped(*args, **kwargs))

    net_wrong = copy.deepcopy(net_cpu)
    net_wrong.zero_grad(set_to_none=True)
    try:
        ppo_module.gae_per_key = one_column_wrong
        loss_wrong = cpu_loss(net_wrong, view_cpu)
    finally:
        ppo_module.gae_per_key = shipped
    wrong_loss_share = loss_share(loss_wrong)
    wrong_grad_share = grad_share([p.grad for p in net_wrong.parameters()])

    def one_launch_per_key(rewards, values, last_values, done, truncated, lambda_, gamma,
                           batch_major=False):
        done = tree_map(lambda _: done, rewards) if torch.is_tensor(done) else done
        truncated = tree_map(lambda _: truncated, rewards) if torch.is_tensor(truncated) else truncated
        return tree_map(lambda r, v, lv, d, tr: gae_cuda(r, v, lv, d, tr, lambda_, gamma,
                                                         batch_major),
                        rewards, values, last_values, done, truncated)

    n_keys = len(view.rewards) if isinstance(view.rewards, dict) else 1
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
    print(f"reference {label}: largest |grad| {max_grad:.3g}; with one GAE launch per key "
          f"({n_keys}) loss and gradients torch.equal True; one GAE column of {width} wrong on "
          f"the CPU would read, as a share of the limit, loss {wrong_loss_share:.3g}, gradients "
          f"{wrong_grad_share:.3g} ({time.perf_counter() - t0:.1f} s)")
    return abs(loss_gpu.item() - loss_cpu.item())


def replay_modes_phase(torch, label: str, env, config, ts) -> None:
    """The loss and gradients of one full-width minibatch of a fresh
    rollout on the card, with the fused replay (the recurrent cells'
    hoisted input projections) against the whole-net step scan
    (``fused_replay=False``), at ``LOSS_LIMITS``: the same function, its
    float32 sums associated differently."""
    from nnx_ppo_tpu_torch.algorithms import ppo_loss
    from nnx_ppo_tpu_torch.algorithms.ppo import ReplayMinibatch
    from nnx_ppo_tpu_torch.algorithms.rollout import unroll_env
    from nnx_ppo_tpu_torch.core.struct import tree_map

    net = ts.networks
    with torch.no_grad():
        _, _, rollout = unroll_env(env, ts.env_states, net, ts.network_states,
                                   config.rollout_length, ts.generator)
    width = config.n_envs // config.n_minibatches
    view = first_envs(torch, ReplayMinibatch.from_rollout(rollout), width)
    results = {}
    for fused in (True, False):
        net.zero_grad(set_to_none=True)
        loss, _ = ppo_loss(
            net, tree_map(lambda x: x[:width], ts.network_states), view,
            clip_range=config.clip_range, normalize_advantages=True,
            combine_advantages=config.combine_advantages,
            discounting_factor=config.discounting_factor, gae_lambda=config.gae_lambda,
            critic_loss_weight=1.0, logging_level=config.logging_level, fused_replay=fused,
        )
        loss.backward()
        results[fused] = (loss.detach(), [p.grad.clone() for p in net.parameters()])
    net.zero_grad(set_to_none=True)
    (loss_f, grads_f), (loss_s, grads_s) = results[True], results[False]
    lim = LOSS_LIMITS
    loss_share, grad_share = shares_of_limit(loss_f.item(), grads_f, loss_s.item(), grads_s, lim)
    print(f"replay modes {label}: loss fused {loss_f.item():.6f} unfused {loss_s.item():.6f}; share "
          f"of the limit (loss rtol {lim['loss_rtol']:g} atol {lim['loss_atol']:g}, gradients rtol "
          f"{lim['grad_rtol']:g} atol {lim['grad_atol']:g}): loss {loss_share:.3g}, gradients "
          f"{grad_share:.3g}")
    check(loss_share <= 1.0 and grad_share <= 1.0,
          f"{label}: fused and unfused replay agree within LOSS_LIMITS")


def env_step_reference_phase(torch, label: str, env, kernels: list, per_env_step: dict,
                             reward_atol: float = 1e-4) -> None:
    """One step of a legged path's env on the card (its kernels) against
    the CPU (plain versions): same state, action and draws.
    ``per_env_step`` maps each kernel wrapper's name to its launches per
    env step. float32; one control step of ten substeps: qpos 2e-4, qvel
    2e-3; obs 2e-3 (it holds qvel); rewards ``reward_atol`` (1e-4 for the
    quadruped, 5e-4 for the humanoid); contact force rtol 5e-3 / atol
    5e-2."""
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
    # What a wrong step reads against the same limits, on the paths of the
    # control-step kernel: the CPU step again with one substep fewer (a
    # kernel that dropped its last substep).
    wrong = None
    if legged._control_runner is not None:
        wrong_env = copy.copy(legged)
        wrong_env._control_runner = copy.copy(legged._control_runner)
        wrong_env._control_runner.n_substeps -= 1
        wrong = wrong_env._step_from(
            to_cpu(state), action.cpu(), None if push is None else to_cpu(push),
            to_cpu(resample), None,
        )
    torch.cuda.synchronize()
    got, want = to_cpu(on_card), on_cpu
    check(bool((want.metrics["contact_force"] > 0).any()), "feet are in contact")
    torch.testing.assert_close(got.data["qpos"], want.data["qpos"], rtol=0, atol=2e-4)
    torch.testing.assert_close(got.data["qvel"], want.data["qvel"], rtol=0, atol=2e-3)
    for key in want.obs:
        torch.testing.assert_close(got.obs[key], want.obs[key], rtol=0, atol=2e-3)
    for key in want.reward:
        torch.testing.assert_close(got.reward[key], want.reward[key], rtol=0, atol=reward_atol)
    torch.testing.assert_close(got.done, want.done, rtol=0, atol=0)
    torch.testing.assert_close(
        got.metrics["contact_force"], want.metrics["contact_force"], rtol=5e-3, atol=5e-2
    )
    def errors(state) -> str:
        reward = max((state.reward[k] - want.reward[k]).abs().max().item() for k in want.reward)
        return (f"qpos {(state.data['qpos'] - want.data['qpos']).abs().max().item():.3g} (atol "
                f"2e-4) qvel {(state.data['qvel'] - want.data['qvel']).abs().max().item():.3g} "
                f"(atol 2e-3) reward {reward:.3g} (atol {reward_atol:g})")

    print(f"reference env.step {label}: max_abs_err {errors(got)} over {B} envs" + (
        "" if wrong is None else f"; a step of {legged.n_substeps - 1} substeps on the CPU "
        f"would read {errors(wrong)}"))


def kernel_vs_generic_phase(torch) -> dict:
    """Each kernel against the generic engine (an independent
    implementation: 6x6 spatial algebra in eager PyTorch, against the
    kernels' scalar lane forms) on the card, from the same state, for one
    control step, at the tolerances of the JAX package's own checks of its
    kernels against its generic engine: the control step (held factor)
    qpos rtol / atol 2e-4, qvel 2e-3 (tests/test_physics_soa.py:79-82), on
    the physics leg's quadruped (randomization, one push in four envs,
    rough terrain) and on the MJCF quadruped, through the env (the kernel
    path against substep_impl="xla"), foot contact force rtol 5e-3 / atol
    5e-2; the scene kernel qpos 2e-5, qvel 2e-4, normals 1e-4
    (tests/test_soa_general.py:81-87) on the reacher (every normal) and the
    pusher (the cross pair: scene_step returns only its normals). Beside
    each, what the generic step with one substep fewer reads, as a share
    of the same limits."""
    import numpy as np

    from nnx_ppo_tpu_torch.envs import ArmPush, ArmReacher, QuadrupedJoystick
    from nnx_ppo_tpu_torch.physics import DomainRandomization, engine
    from nnx_ppo_tpu_torch.physics.models import mjcf_quadruped
    from nnx_ppo_tpu_torch.physics.scene import scene_step
    from nnx_ppo_tpu_torch.physics.terrain import rough_terrain
    from nnx_ppo_tpu_torch.physics.testing import manipulation_states

    rows, failures = {}, []
    legged = {
        "quadruped_physics_leg": lambda impl: QuadrupedJoystick(
            reuse_mass_matrix=True, randomize=DomainRandomization(**DR_RANGES), push_prob=0.02,
            push_force=50.0, terrain=rough_terrain(**ROUGH), depthwise=False, substep_impl=impl),
        "mjcf_quadruped": lambda impl: mjcf_quadruped.make_env(
            reuse_mass_matrix=True, depthwise=False, substep_impl=impl),
    }
    B = 2048
    for label, make in legged.items():
        kernel_env, generic_env = make("pallas"), make("xla")
        g = torch.Generator(device="cuda")
        g.manual_seed(13)
        state = kernel_env.reset(B, g)
        action = 2.4 * torch.rand((B, kernel_env.action_size), generator=g, device="cuda") - 1.2
        push = None
        if kernel_env.push_force > 0.0:
            push = (torch.arange(B, device="cuda") % 4 == 0, kernel_env._draw_push(B, g)[1])
        resample = kernel_env._draw_resample(B, g)
        short_env = copy.copy(generic_env)
        short_env.n_substeps -= 1
        got, want, short = (e._step_from(state, action, push, resample, None)
                            for e in (kernel_env, generic_env, short_env))
        torch.cuda.synchronize()
        check(bool((want.metrics["contact_force"] > 0).any()), f"{label}: feet are in contact")
        limits = {"qpos": (2e-4, 2e-4), "qvel": (2e-3, 2e-3)}
        row = {}
        for key, (rtol, atol) in limits.items():
            row[key] = share_of_limit(got.data[key], want.data[key], rtol, atol)
            row[f"{key}_short"] = share_of_limit(short.data[key], want.data[key], rtol, atol)
            row[f"{key}_max_abs_err"] = (got.data[key] - want.data[key]).abs().max().item()
        row["contact_force"] = share_of_limit(got.metrics["contact_force"],
                                              want.metrics["contact_force"], 5e-3, 5e-2)
        rows[label] = row
        print(f"control step against the generic engine, {label}, B={B}: qpos "
              f"{row['qpos_max_abs_err']:.3g} ({row['qpos']:.3f} of rtol/atol 2e-4), qvel "
              f"{row['qvel_max_abs_err']:.3g} ({row['qvel']:.3f} of 2e-3), contact force "
              f"{row['contact_force']:.3f} of rtol 5e-3 / atol 5e-2; a generic step of "
              f"{generic_env.n_substeps - 1} substeps would read qpos {row['qpos_short']:.1f} "
              f"and qvel {row['qvel_short']:.1f} of the limits")
        failures += [f"{label} {k}" for k in ("qpos", "qvel", "contact_force") if row[k] > 1.0]

    B = 1024
    for label, env in (("reacher", ArmReacher()), ("pusher", ArmPush())):
        pusher = label == "pusher"
        run = env._scene_runner
        arrays = manipulation_states(B, seed=14, with_ball=pusher,
                                     shoulder_height=0.55 if pusher else 1.0)
        qpos, qvel, tau = (torch.tensor(arrays[k], device="cuda") for k in ("qpos", "qvel", "tau"))

        def generic(n_substeps):
            if not pusher:
                return engine.step(env.model, qpos, qvel, tau, run.dt, n_substeps)
            arm = env.scene.models[0]
            split = lambda x, n: (x[:, :n], x[:, n:])
            qps, qvs, cross = scene_step(env.scene, split(qpos, arm.nq), split(qvel, arm.nv),
                                         split(tau, arm.nv), run.dt, n_substeps)
            return torch.cat(qps, dim=-1), torch.cat(qvs, dim=-1), cross

        got = run.cuda(qpos, qvel, tau)
        want, short = generic(run.n_substeps), generic(run.n_substeps - 1)
        torch.cuda.synchronize()
        got_normals = got[2][:, -1:] if pusher else got[2]
        if pusher:
            check(bool((want[2] > 0).any() and (want[2] == 0).any()),
                  "pusher: the cross pair touches in some envs, not in others")
        row = {}
        for i, (key, tol) in enumerate((("qpos", 2e-5), ("qvel", 2e-4), ("normals", 1e-4))):
            g_i = got_normals if key == "normals" else got[i]
            row[key] = share_of_limit(g_i, want[i], tol, tol)
            row[f"{key}_short"] = share_of_limit(short[i], want[i], tol, tol)
            row[f"{key}_max_abs_err"] = (g_i - want[i]).abs().max().item()
        rows[label] = row
        print(f"scene step against the generic engine, {label}, B={B}, {run.n_substeps} "
              f"substeps: qpos {row['qpos_max_abs_err']:.3g} ({row['qpos']:.3f} of rtol/atol "
              f"2e-5), qvel {row['qvel_max_abs_err']:.3g} ({row['qvel']:.3f} of 2e-4), normals "
              f"{row['normals_max_abs_err']:.3g} ({row['normals']:.3f} of 1e-4); a generic step "
              f"of {run.n_substeps - 1} substeps would read qpos {row['qpos_short']:.1f}, qvel "
              f"{row['qvel_short']:.1f}, normals {row['normals_short']:.1f} of the limits")
        failures += [f"{label} {k}" for k in ("qpos", "qvel", "normals") if row[k] > 1.0]
    check(not failures, f"kernels against the generic engine within the limits: {failures}")
    return rows


def engine_card_vs_cpu_phase(torch) -> dict:
    """The generic engine's forward_dynamics on the card against the CPU,
    on the tree with every joint type (free root, hinge with a stop and a
    spring, two slides, a ball, a sphere pair) and on the fixed-base tree
    rooted by a slide (physics/testing.py), 1024 states each, dt = 2 ms:
    qacc and normals at rtol 1e-5 and atol 1e-5 times the largest entry
    (at least 1), the tolerance of the engine's CPU parity with the JAX
    package (tests/test_torch_generic_engine.py)."""
    from nnx_ppo_tpu_torch.physics import forward_dynamics
    from nnx_ppo_tpu_torch.physics.testing import (
        general_tree, general_tree_states, slider_tree, slider_tree_states,
    )

    rows = {}
    for label, model, arrays in (
        ("general_tree", general_tree(), general_tree_states(1024, seed=9)),
        ("slider_tree", slider_tree(), slider_tree_states(1024, seed=10)),
    ):
        cpu = [torch.tensor(arrays[k]) for k in ("qpos", "qvel", "tau")]
        want = forward_dynamics(model, *cpu, dt=0.002)
        got = forward_dynamics(model, *(x.cuda() for x in cpu), dt=0.002)
        torch.cuda.synchronize()
        row = {}
        for key, g, w in zip(("qacc", "normals"), got, want):
            g = g.cpu()
            scale = max(1.0, w.abs().max().item())
            row[key] = share_of_limit(g, w, 1e-5, 1e-5 * scale)
            row[f"{key}_max_abs_err"] = (g - w).abs().max().item()
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * scale)
        rows[label] = row
        print(f"generic engine on the card against the CPU, {label}: qacc "
              f"{row['qacc_max_abs_err']:.3g} ({row['qacc']:.3f} of the limit), normals "
              f"{row['normals_max_abs_err']:.3g} ({row['normals']:.3f} of the limit)")
    return rows


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
    # The module: the package exports the function gae under its name.
    gae_module = importlib.import_module("nnx_ppo_tpu_torch.ops.gae")

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


# The kernels at a batch of one env, the video's render rollout batch:
# label -> (wrapper, kernel name, the case it cuts to one env). A lane-group
# block then holds one env and empty slots (the control step and substeps 8
# envs per 128 threads, the plane sampler 8 per 64, the scene 16 per 64).
ONE_ENV_CASES = {
    "control_step held, full features": ("control_step_cuda", "control_step_kernel",
                                         "held, full features, B=2048"),
    "control_step exact, full features": ("control_step_cuda", "control_step_kernel",
                                          "exact, full features, B=2048"),
    "control_step held, flat ground": ("control_step_cuda", "control_step_kernel",
                                       "held, flat ground, no extras, B=2048"),
    "plane_sampler on the 256x256 table": ("plane_sampler_cuda", "plane_sampler_kernel",
                                           "B=2048 on the 256x256 table"),
    "control_step on the sampled planes": ("control_step_cuda", "control_step_kernel",
                                           "B=2048 on the 256x256 table"),
    "substeps, ten in one launch": ("substeps_cuda", "substeps_kernel", None),
    "scene_step pusher": ("scene_step_cuda", "scene_step_kernel", "pusher, B=4096"),
    "scene_step reacher": ("scene_step_cuda", "scene_step_kernel", "reacher, B=4096"),
}


def one_env_call(label: str, torch):
    """(kernel call, plain call) of one :data:`ONE_ENV_CASES` entry at one
    env; each returns the outputs as a tuple."""
    from nnx_ppo_tpu_torch.physics import cuda_step
    from nnx_ppo_tpu_torch.physics.engine import mass_matrix_factor
    from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
    from nnx_ppo_tpu_torch.physics.testing import standing_states

    wrapper, _, case = ONE_ENV_CASES[label]
    if label.startswith("plane_sampler"):
        plan, args = plane_sampler_case(case, torch, batch=1)
        return (lambda: (plan.sample_planes_cuda(args[0]),),
                lambda: (plan.sample_planes_plain(args[0]),))
    if label == "control_step on the sampled planes":
        plan, args = plane_sampler_case(case, torch, batch=1)
    elif wrapper == "control_step_cuda":
        plan, args = control_step_case(case, torch, batch=1)
    elif wrapper == "scene_step_cuda":
        plan, args = scene_step_case(case, torch, batch=1)
    else:
        model = make_quadruped()
        arrays = standing_states(model, default_qpos(model), 1, seed=3)
        args = [torch.tensor(arrays[k], device="cuda") for k in ("qpos", "qvel", "target")]
        args.append(mass_matrix_factor(model, args[0], dt=0.002))
        run = cuda_step.make_substep_runner(model, 60.0, 0.002, 10, -1)
        return (lambda: run(*args),
                lambda: cuda_step.substeps_plain(model, *args, 60.0, 0.002, 10))
    return lambda: plan.cuda(*args), lambda: plan.plain(*args)


def one_env_kernel_phase(torch, wrappers: list) -> dict:
    """Every physics kernel launched for one env against its plain version
    on the same inputs: each output must be equal to the bit, as at 33
    envs and more (the block's empty env slots must write nothing and
    leave no barrier short); then the device time of one launch by the
    profiler. Returns, per wrapper, its cases."""
    counters = {k.__name__: k for k in wrappers}
    rows: dict = {}
    for label, (wrapper, kernel, _) in ONE_ENV_CASES.items():
        run, plain = one_env_call(label, torch)
        before = counters[wrapper].launches
        got = run()
        torch.cuda.synchronize()
        check(counters[wrapper].launches == before + 1, f"{label} at one env: one launch counted")
        want = plain()
        torch.cuda.synchronize()
        check(all(g.shape[0] == 1 for g in got), f"{label}: one env out")
        equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        check(equal, f"{label} at one env equals the plain version to the bit (max abs err {err})")
        device_us = 1e3 * device_ms_per_call(run, 50, kernel, torch)
        rows.setdefault(wrapper, {})[label] = {"batch": 1, "equal": equal, "max_abs_err": err,
                                               "device_us": device_us}
        print(f"one env, {label}: torch.equal True, max_abs_err {err:.3g}, {device_us:.2f} us "
              "per launch (profiler)")
    return rows


CHECKPOINT_ITERATIONS = 2  # k: the resumed run restarts after k of 2k iterations


def saved_tensors(torch, state, directory: str) -> tuple[dict, float]:
    """Every named tensor a checkpoint of ``state`` holds (weights,
    statistics, optimizer moments and counts, carries, env states, the
    generator's state, the step count), by saving one; and the save's
    milliseconds."""
    from nnx_ppo_tpu_torch.algorithms import save_checkpoint
    from nnx_ppo_tpu_torch.algorithms.checkpointing import TENSORS_FILE

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(directory, state, 0)
    save_ms = (time.perf_counter() - t0) * 1e3
    return torch.load(os.path.join(directory, "state", TENSORS_FILE), weights_only=True), save_ms


def leaf_differences(torch, a: dict, b: dict) -> dict:
    """Per name: 0.0 where the two tensors are equal to the bit (NaN in
    the same places), else the largest absolute difference (inf for a
    differing generator state or a NaN in one place only)."""
    out = {}
    for name, x in a.items():
        y = b[name]
        if torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num()):
            out[name] = 0.0
        elif x.dtype == torch.uint8 or not torch.equal(x.isnan(), y.isnan()):
            out[name] = float("inf")
        else:
            out[name] = (x.double() - y.double()).abs().max().item()
    return out


def checkpoint_path_phase(torch, wrappers: list, label: str, leg, per_step: dict,
                          directory: str) -> dict:
    """A path at full width through train_ppo with make_checkpoint_fn: 2k
    iterations twice from one seed (``anneal_lr``, so the schedule's
    count is part of the state), then the first run's checkpoint at k
    loaded into a fresh template (another seed) and trained to 2k. Where
    the two uninterrupted runs are equal to the bit, the resumed one must
    be too; else it must lie no further from the first than the second
    does. Every kernel's count is set to 0 before each run and read
    after."""
    from nnx_ppo_tpu_torch.algorithms import (
        EvalConfig, TrainConfig, load_checkpoint, make_checkpoint_fn, new_training_state,
        train_ppo,
    )

    env, networks, ppo, _ = leg(torch)
    per_iter = ppo.n_envs * ppo.rollout_length
    k = CHECKPOINT_ITERATIONS
    config = TrainConfig(
        ppo=dataclasses.replace(ppo, total_steps=2 * k * per_iter, anneal_lr=True),
        eval=EvalConfig(enabled=False), checkpoint_every_steps=k * per_iter, seed=0,
    )
    launches = {w.__name__: 0 for w in wrappers}
    save_ms: list = []

    def train(run: str, **kwargs):
        saver = make_checkpoint_fn(os.path.join(directory, run), config)

        def timed_saver(state, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saver(state, step)
            save_ms.append((time.perf_counter() - t0) * 1e3)

        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        res = train_ppo(env, networks, config, checkpoint_fn=timed_saver, **kwargs)
        torch.cuda.synchronize()
        n_iterations = res.total_iterations
        for w in wrappers:
            check(w.launches == per_step[w.__name__] * n_iterations,
                  f"checkpoint {label} {run}: {w.__name__} launches {w.launches}")
            launches[w.__name__] += w.launches
        return res

    first, second = train("first"), train("second")
    step_dir = os.path.join(directory, "first", f"step_{k * per_iter:010d}")
    template = new_training_state(env, networks, ppo.n_envs, seed=1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = load_checkpoint(step_dir, template)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    check(restored["step"] == k * per_iter and restored["config"] == config,
          f"checkpoint {label}: step and config restored")
    resumed = train("resumed", initial_state=restored["training_state"])
    check(first.total_steps == second.total_steps == resumed.total_steps == 2 * k * per_iter,
          f"checkpoint {label}: every run ends at 2k iterations")
    bytes_on_disk = sum(os.path.getsize(os.path.join(root, f))
                        for root, _, files in os.walk(step_dir) for f in files)
    leaves = {run: saved_tensors(torch, res.training_state, os.path.join(directory, f"{run}_end"))[0]
              for run, res in (("first", first), ("second", second), ("resumed", resumed))}
    spread = leaf_differences(torch, leaves["first"], leaves["second"])
    gap = leaf_differences(torch, leaves["first"], leaves["resumed"])
    deterministic = max(spread.values()) == 0.0
    differing = sorted(name for name, d in spread.items() if d)
    if deterministic:
        check(max(gap.values()) == 0.0,
              f"checkpoint {label}: the resumed run equals the uninterrupted one to the bit "
              f"({[n for n, d in gap.items() if d][:5]} differ)")
    else:
        check(max(gap.values()) <= max(spread.values()),
              f"checkpoint {label}: the resumed run lies no further than a second run")
    result = {
        "uninterrupted_runs_equal": deterministic,
        "leaves": len(spread),
        "uninterrupted_leaves_differing": differing,
        "uninterrupted_largest_difference": max(spread.values()),
        "resumed_largest_difference": max(gap.values()),
        "save_ms": save_ms,
        "load_ms": load_ms,
        "bytes_on_disk": bytes_on_disk,
        "launches": launches,
    }
    print(f"checkpoint {label}: two uninterrupted runs of {2 * k} iterations equal to the bit: "
          f"{deterministic} ({len(differing)} of {len(spread)} leaves differ, largest "
          f"{result['uninterrupted_largest_difference']:.3g}{'; ' + ', '.join(differing[:6]) if differing else ''}); "
          f"resumed after {k}: largest difference {result['resumed_largest_difference']:.3g}; "
          f"save {', '.join(f'{ms:.1f}' for ms in save_ms[:3])} ms, load {load_ms:.1f} ms, "
          f"{bytes_on_disk} bytes on disk; launches {launches}")
    return result


def distill_round_trip_phase(torch, path: dict, directory: str) -> dict:
    """A distillation state at full width saved and loaded into a fresh
    template (another seed): every named tensor equal to the bit."""
    from nnx_ppo_tpu_torch.algorithms import load_checkpoint, new_distillation_state

    state, config = path["state"], path["config"]
    original, save_ms = saved_tensors(torch, state, os.path.join(directory, "saved"))
    step_dir = os.path.join(directory, "saved")
    template = new_distillation_state(path["env"], path["teacher"], state.student, config.n_envs,
                                      seed=1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = load_checkpoint(step_dir, template)["training_state"]
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    again, _ = saved_tensors(torch, restored, os.path.join(directory, "again"))
    diffs = leaf_differences(torch, original, again)
    check(max(diffs.values()) == 0.0, "distill_quadruped_2048: the round trip is exact")
    bytes_on_disk = sum(os.path.getsize(os.path.join(root, f))
                        for root, _, files in os.walk(step_dir) for f in files)
    print(f"checkpoint distill_quadruped_2048: state round trip equal to the bit over "
          f"{len(diffs)} leaves; save {save_ms:.1f} ms, load {load_ms:.1f} ms, {bytes_on_disk} "
          "bytes on disk")
    return {"leaves": len(diffs), "equal": True, "save_ms": save_ms, "load_ms": load_ms,
            "bytes_on_disk": bytes_on_disk}


VIDEO_LENGTH = 200
VIDEO_SIZE = (("height", 240), ("width", 320))


def video_phase(torch, wrappers: list) -> dict:
    """The video pipeline on the card: train_ppo with video on the
    flagship (one iteration, the video at step 0, 500-step episode), then
    the render rollout of one env and the render of 200 steps on the
    physics leg's quadruped, the data-terrain quadruped and the pusher
    (random policies in eval mode). Every kernel's count is set to 0
    before each and read after: each env step of the rollout launches its
    physics kernels once, at one env."""
    from nnx_ppo_tpu_torch.algorithms import (
        EvalConfig, LoggingLevel, TrainConfig, VideoConfig, eval_rollout_for_render_scan,
        train_ppo, unstack_trajectory,
    )
    import numpy as np

    from nnx_ppo_tpu_torch.algorithms.rollout import render_seed

    out: dict = {}
    env, networks, ppo, _ = flagship(torch)
    videos, logged = [], []
    config = TrainConfig(
        ppo=dataclasses.replace(ppo, total_steps=ppo.n_envs * ppo.rollout_length,
                                logging_level=LoggingLevel.LOSSES | LoggingLevel.THROUGHPUT),
        eval=EvalConfig(enabled=False),
        video=VideoConfig(enabled=True, episode_length=500, render_kwargs=VIDEO_SIZE),
    )
    for w in wrappers:
        w.launches = 0
    train_ppo(env, networks, config, video_fn=videos.append,
              log_fn=lambda m, s: logged.append((s, m)))
    launches = {w.__name__: w.launches for w in wrappers}
    check(len(videos) == 1 and videos[0].frames.shape == (501, 240, 320, 3),
          f"flagship video: {[v.frames.shape for v in videos]}")
    check(videos[0].frames.dtype.name == "uint8" and (videos[0].frames != 255).any(),
          "flagship video frames are uint8 and not blank")
    video_sps = [m["throughput/video_sps"] for s, m in logged if "throughput/video_sps" in m]
    check(len(video_sps) == 1, "throughput/video_sps logged once")
    check(launches["gae_cuda"] == 16 and sum(launches.values()) == 16,
          f"flagship with video: {launches}")
    out["flagship"] = {"frames": list(videos[0].frames.shape), "video_sps": video_sps[0],
                       "episode_reward": videos[0].episode_reward, "launches": launches}
    print(f"video flagship (train_ppo, 500 steps): frames {videos[0].frames.shape}, video_sps "
          f"{video_sps[0]:.1f}, episode reward {videos[0].episode_reward:.2f}; launches {launches}")

    for label, leg, per_env_step in (
        ("physics", physics_leg, {"control_step_cuda": 1}),
        ("heightgrid", heightgrid_leg, {"plane_sampler_cuda": 1, "control_step_cuda": 1}),
        ("pusher", pusher_leg, {"scene_step_cuda": 1}),
    ):
        env, networks, _, _ = leg(torch)
        net = copy.deepcopy(networks).to("cuda").eval()
        generator = torch.Generator(device="cuda")
        generator.manual_seed(render_seed(0, 0))
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stacked, final, reward = eval_rollout_for_render_scan(env, net, VIDEO_LENGTH, generator)
        rollout_s = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        for name, n in launches.items():
            check(n == per_env_step.get(name, 0) * VIDEO_LENGTH,
                  f"video {label}: {name} launched {n} times in {VIDEO_LENGTH} env steps")
        frames = env.render(unstack_trajectory(stacked, final, VIDEO_LENGTH), **dict(VIDEO_SIZE))
        total_s = time.perf_counter() - t0
        frames = np.stack(frames)
        check(frames.shape == (VIDEO_LENGTH + 1, 240, 320, 3) and frames.dtype == np.uint8,
              f"video {label}: frames {frames.shape}")
        check(bool((frames != 255).any()) and bool(np.isfinite(float(reward))),
              f"video {label}: frames drawn, reward finite")
        per_step = {name: n / VIDEO_LENGTH for name, n in launches.items() if n}
        out[label] = {"frames": list(frames.shape), "video_sps": VIDEO_LENGTH / total_s,
                      "rollout_s": rollout_s, "render_s": total_s - rollout_s,
                      "episode_reward": float(reward), "kernels_per_env_step": per_step,
                      "launches": launches}
        print(f"video {label} (one env, {VIDEO_LENGTH} steps): frames {frames.shape}, video_sps "
              f"{VIDEO_LENGTH / total_s:.1f} (rollout {rollout_s:.2f} s, render "
              f"{total_s - rollout_s:.2f} s), kernels per env step {per_step}, every one a "
              "launch at one env through its kernel")
    return out


def step_split_phase(torch, label: str, env, config, state, profile_dir: str) -> dict:
    """One ppo_step under ``utils.profiling.trace`` (a Chrome trace into
    ``profile_dir``): host ms (the ranges' CPU time) and device ms (the
    kernels launched inside each range) of ``unroll_env`` and
    ``ppo_update``, each as a share of ``ppo_step``'s."""
    from torch.autograd import DeviceType

    from nnx_ppo_tpu_torch.algorithms import make_optimizer, ppo_step
    from nnx_ppo_tpu_torch.utils import profiling

    optimizer = make_optimizer(config.learning_rate)
    with profiling.trace(os.path.join(profile_dir, f"{label}_trace")) as prof:
        state, _ = ppo_step(env, state, config, optimizer)
        torch.cuda.synchronize()
    ranges = {e.key: e for e in prof.key_averages()
              if e.key in ("ppo_step", "unroll_env", "ppo_update")
              and e.device_type == DeviceType.CPU}
    check(set(ranges) == {"ppo_step", "unroll_env", "ppo_update"},
          f"{label}: the trace holds the step's ranges ({sorted(ranges)})")
    out = {name: {"host_ms": e.cpu_time_total / 1e3, "device_ms": e.device_time_total / 1e3}
           for name, e in ranges.items()}
    step = out["ppo_step"]
    for name in ("unroll_env", "ppo_update"):
        out[name]["host_share"] = out[name]["host_ms"] / step["host_ms"]
        out[name]["device_share"] = (out[name]["device_ms"] / step["device_ms"]
                                     if step["device_ms"] else float("nan"))
    print(f"profile {label}: ppo_step host {step['host_ms']:.2f} ms, device {step['device_ms']:.2f} "
          f"ms; unroll_env host {out['unroll_env']['host_ms']:.2f} ms "
          f"({out['unroll_env']['host_share']:.3f}), device {out['unroll_env']['device_ms']:.2f} ms "
          f"({out['unroll_env']['device_share']:.3f}); ppo_update host "
          f"{out['ppo_update']['host_ms']:.2f} ms ({out['ppo_update']['host_share']:.3f}), device "
          f"{out['ppo_update']['device_ms']:.2f} ms ({out['ppo_update']['device_share']:.3f}) on "
          f"{card_line()}")
    return out


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

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nnx_ppo_tpu_torch.algorithms import make_optimizer, new_training_state, ppo_step
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
    t_kernels = time.perf_counter()
    gae_kernel = gae_kernel_phase(torch)
    control_kernel = control_step_kernel_phase(torch, args.variants)
    sampler_kernel = plane_sampler_kernel_phase(torch)
    substeps_kernel = substeps_kernel_phase(torch, bool(args.profile))
    scene_kernel = scene_step_kernel_phase(torch, args.variants)
    one_env = one_env_kernel_phase(torch, wrappers)
    print(f"kernel phases: {time.perf_counter() - t_kernels:.1f} s")
    t_paths = time.perf_counter()

    flagship_path = flagship_path_phase(torch, wrappers, args.profile)
    flagship_env, _, flagship_config, _ = flagship(torch)
    loss_reference_phase(torch, "flagship", flagship_env, flagship_config,
                         flagship_path["state"])
    layout_reference_phase(torch, "flagship", flagship_env, flagship_config,
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
        "humanoid": dict(none, gae_cuda=16, control_step_cuda=20),
        "humanoid_full": dict(none, gae_cuda=16, control_step_cuda=20),
        "locomotion": dict(none, gae_cuda=16),
        "heavy_physics": dict(none, gae_cuda=16),
        **{label: dict(none, gae_cuda=16) for label in NETWORK_PATHS},
        "quadruped_2048_pallas_bf16store": dict(none, gae_cuda=16, control_step_cuda=20),
        "mjcf_quadruped_2048": dict(none, gae_cuda=16, control_step_cuda=20),
        # The generic engine: no physics kernel.
        "quadruped_2048_fastM_generic": dict(none, gae_cuda=16),
        # Distillation: the dual rollout's 20 control steps, no GAE.
        **{label: dict(none, control_step_cuda=20) for label in DISTILL_PATHS},
    }
    physics_wrappers = wrappers[1:4]

    def per_env_step(label: str) -> dict:
        return {k.__name__: per_step[label][k.__name__] // 20 for k in physics_wrappers}

    physics_path = physics_path_phase(
        torch, wrappers, args.profile, "physics", physics_leg, PHYSICS_STEPS_CHECKED,
        PHYSICS_STEPS_TIMED, per_step["physics"], PHYSICS_STEPS_NOSHUFFLE,
    )
    # The atol scaled with each gradient tensor's largest entry, as on the
    # humanoid and analytic paths, on the evidence of a float64 witness:
    # batch-major, this minibatch reads 1.71 of the fixed 1e-5 on the H100
    # (2.27e-5 on an entry of 3.3e-3 in the actor head, largest 2.56),
    # while the card's and the CPU's float32 gradients each read 58.5 and
    # 60.1 of the fixed limit against the loss in float64: float32 on
    # either device lies far further from the function than the two lie
    # from each other (the replay recomputes the log-likelihood of a stored
    # float32 sample, whose rounding 1/std^2 amplifies where std is near
    # its 1e-3 floor), so the fixed atol bounds no float32 result here.
    loss_reference_phase(torch, "physics", physics_path["env"], physics_path["config"],
                         physics_path["state"], scaled_grad_atol=True, float64_witness=True)
    layout_reference_phase(torch, "physics", physics_path["env"], physics_path["config"],
                           physics_path["state"])
    # The bf16 replay store on the flat quadruped, then distillation on the
    # same env and net (the control-step kernel under a dual rollout).
    bf16store_label = "quadruped_2048_pallas_bf16store"
    bf16store_path = physics_path_phase(
        torch, wrappers, args.profile, bf16store_label, bf16store_leg, PHYSICS_STEPS_CHECKED,
        PHYSICS_STEPS_TIMED, per_step[bf16store_label],
    )
    loss_reference_phase(torch, bf16store_label, bf16store_path["env"], bf16store_path["config"],
                         bf16store_path["state"], scaled_grad_atol=True, float64_witness=True)
    bf16_store_equality_phase(torch)
    distill_paths = {
        label: distill_path_phase(torch, wrappers, args.profile, label, shuffle, checked, timed,
                                  per_step[label])
        for label, (shuffle, checked, timed) in DISTILL_PATHS.items()
    }
    for label, path in distill_paths.items():
        distillation_reference_phase(torch, label, path)
    # The MJCF quadruped (the control step at a third model's sizes) and the
    # quadruped on the generic engine; each path's device profile of one
    # more ppo_step (kernels, busy time, idle share).
    new_paths = {
        label: physics_path_phase(torch, wrappers, args.profile, label, leg, checked, timed,
                                  per_step[label])
        for label, leg, checked, timed in (
            ("mjcf_quadruped_2048", mjcf_quadruped_leg, MJCF_STEPS_CHECKED, MJCF_STEPS_TIMED),
            ("quadruped_2048_fastM_generic", generic_quadruped_leg, GENERIC_STEPS_CHECKED,
             GENERIC_STEPS_TIMED),
        )
    }
    new_path_profiles = {}
    for label, path in new_paths.items():
        env, config = path["env"], path["config"]
        optimizer = make_optimizer(config.learning_rate)
        path["state"], new_path_profiles[label] = step_device_profile(
            torch, lambda: ppo_step(env, path["state"], config, optimizer)[0], path["step_ms"],
            label)
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
    humanoid_paths = {
        label: physics_path_phase(
            torch, wrappers, args.profile, label, leg, HUMANOID_STEPS_CHECKED,
            HUMANOID_STEPS_TIMED, per_step[label],
        )
        for label, leg in (("humanoid", humanoid_leg), ("humanoid_full", humanoid_full_leg))
    }
    analytic_paths = {
        label: physics_path_phase(
            torch, wrappers, args.profile, label, leg, ANALYTIC_STEPS_CHECKED,
            ANALYTIC_STEPS_TIMED, per_step[label],
        )
        for label, leg in (("locomotion", locomotion_leg), ("heavy_physics", heavy_physics_leg))
    }
    for label, path in {**humanoid_paths, **analytic_paths}.items():
        loss_reference_phase(torch, label, path["env"], path["config"], path["state"],
                             scaled_grad_atol=True)
    # The networks paths: recurrent (GRU, fused and unfused), the
    # population graph, the widest MLP in bf16; GAE only.
    network_paths = {
        label: physics_path_phase(torch, wrappers, args.profile, label, leg, checked,
                                  timed, per_step[label])
        for label, (leg, checked, timed) in NETWORK_PATHS.items()
    }
    for label in ("gru_1024", "gru_1024_unfused", "population_graph_1024"):
        path = network_paths[label]
        loss_reference_phase(torch, label, path["env"], path["config"], path["state"])
    gru_path = network_paths["gru_1024"]
    replay_modes_phase(torch, "gru_1024", gru_path["env"], gru_path["config"], gru_path["state"])
    wide = network_paths["mlp_wide_bf16_8192"]
    tflop = dense_tflop_per_step(wide["state"].networks, wide["config"])
    print(f"mlp_wide_bf16_8192: {tflop:.2f} TFLOP of Dense matmuls per ppo_step, "
          f"{tflop / wide['step_ms'] * 1e3:.1f} TFLOP/s over the whole step; "
          f"{tflop / FP32_FLOPS_PER_S * 1e15:.1f} ms at the float32 peak (the products are float32 "
          f"GEMMs of bf16-rounded operands) and {tflop / BF16_FLOPS_PER_S * 1e15:.1f} ms at the bf16 "
          f"tensor-core peak")
    # 512 of the path's 2048 minibatch columns: the CPU's forward and
    # backward of the wide net over 20 x 2048 rows, twice, would take a
    # quarter of the run.
    loss_reference_phase(torch, "mlp_wide_bf16_8192", wide["env"], wide["config"], wide["state"],
                         limits=BF16_LOSS_LIMITS, width=512)
    # The other modules, no timed steps: a fresh training state each.
    for label, leg in (("lstm", lstm_leg), ("delay_ar1", delay_ar1_leg)):
        env, networks, config, optimizer = leg(torch)
        ts = new_training_state(env, networks, config.n_envs, seed=0, optimizer=optimizer,
                                device="cuda")
        loss_reference_phase(torch, label, env, config, ts)
    # After every path has been driven and its counts read: these steps
    # launch kernels too and must not count as the main paths'.
    for label, path in quadruped_paths.items():
        env_step_reference_phase(torch, label, path["env"], physics_wrappers, per_env_step(label))
    # The flat quadruped of the bf16-store and distillation paths.
    distill_label = next(iter(DISTILL_PATHS))
    env_step_reference_phase(torch, distill_label, distill_paths[distill_label]["env"],
                             physics_wrappers, per_env_step(distill_label))
    for label, path in humanoid_paths.items():
        # The humanoid's stiffer PD (350) and contacts (12,000 N/m) spread
        # card-against-CPU rounding further than the quadruped's, whose
        # 1e-4 stays as it was: on the H100 the held path read 1.78e-4
        # and the exact one 1.49e-5 (fixed seeds; the same in two runs),
        # and the limit is 5e-4, 2.8 times the larger. A step of one
        # substep fewer, printed beside it, shows what a wrong step reads.
        env_step_reference_phase(torch, label, path["env"], physics_wrappers, per_env_step(label),
                                 reward_atol=5e-4)
    for label, path in manipulation_paths.items():
        manipulation_env_step_reference_phase(torch, label, path["env"], scene_step_cuda)
    # The new paths' env step on the card against the CPU, then each kernel
    # against the generic engine on the card, and the generic engine on the
    # card against the CPU.
    for label, path in new_paths.items():
        env_step_reference_phase(torch, label, path["env"], physics_wrappers,
                                 per_env_step(label))
    kernel_vs_generic = kernel_vs_generic_phase(torch)
    engine_card_vs_cpu = engine_card_vs_cpu_phase(torch)
    print(f"paths and references: {time.perf_counter() - t_paths:.1f} s")

    # Checkpoint and exact resume, the video pipeline, and
    # (with --profile) the rollout's and the update's shares of a step.
    t_slice = time.perf_counter()
    checkpoint_dir = os.path.join("build", "smoke_checkpoints")
    shutil.rmtree(checkpoint_dir, ignore_errors=True)
    per_step["flagship"] = dict(none, gae_cuda=16)
    checkpoints = {
        label: checkpoint_path_phase(torch, wrappers, label, leg, per_step[label],
                                     os.path.join(checkpoint_dir, label))
        for label, leg in (("flagship", flagship), ("physics", physics_leg))
    }
    checkpoints["distill_quadruped_2048"] = distill_round_trip_phase(
        torch, distill_paths["distill_quadruped_2048"], os.path.join(checkpoint_dir, "distill"))
    shutil.rmtree(checkpoint_dir, ignore_errors=True)
    videos = video_phase(torch, wrappers)
    step_split = {}
    if args.profile:
        for label, path in (("flagship", flagship_path), ("physics", physics_path)):
            env = flagship_env if label == "flagship" else path["env"]
            config = flagship_config if label == "flagship" else path["config"]
            step_split[label] = step_split_phase(torch, label, env, config, path["state"],
                                                 args.profile)
    print(json.dumps({"checkpoint": {k: {n: v for n, v in c.items() if n != "launches"}
                                     for k, c in checkpoints.items()},
                      "video": {k: {n: v for n, v in c.items() if n != "launches"}
                                for k, c in videos.items()},
                      "step_split": step_split}))
    print(f"checkpoint, video and profile phases: {time.perf_counter() - t_slice:.1f} s")
    if args.learn:
        learning_phase(torch, args.learn)
    if args.phases:
        phases_phase(torch)

    # Launches on the main paths only (the comparisons above do not
    # count: every count was set to 0 just before each path).
    by_path = {"flagship": flagship_path["launches"]}
    training_paths = {**quadruped_paths, **manipulation_paths, **humanoid_paths, **analytic_paths,
                      **network_paths, bf16store_label: bf16store_path, **new_paths}
    by_path.update({label: path["launches"] for label, path in training_paths.items()})
    by_path.update({label: path["launches"] for label, path in distill_paths.items()})
    by_path.update({f"checkpoint_{label}": c["launches"] for label, c in checkpoints.items()
                    if "launches" in c})
    by_path.update({f"video_{label}": v["launches"] for label, v in videos.items()})
    kernel_rows = {
        "gae_cuda": gae_kernel, "control_step_cuda": control_kernel,
        "plane_sampler_cuda": sampler_kernel, "substeps_cuda": substeps_kernel,
        "scene_step_cuda": scene_kernel,
    }
    for wrapper_name, kernel in kernel_rows.items():
        kernel["launches_by_path"] = {k: p[wrapper_name] for k, p in by_path.items()}
        kernel["launches"] = sum(kernel["launches_by_path"].values())
        kernel["one_env"] = one_env.get(wrapper_name, {})
        check(kernel["launches"] > 0, f"{kernel['name']} was launched on a main path")

    print(
        f"flagship ({flagship_path['layout']}): {FLAGSHIP_STEPS_CHECKED + FLAGSHIP_STEPS_TIMED} "
        "ppo_steps, "
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
             "reacher": MANIPULATION_STEPS_TIMED, "humanoid": HUMANOID_STEPS_TIMED,
             "humanoid_full": HUMANOID_STEPS_TIMED, "locomotion": ANALYTIC_STEPS_TIMED,
             "heavy_physics": ANALYTIC_STEPS_TIMED,
             **{label: timed for label, (_, _, timed) in NETWORK_PATHS.items()},
             bf16store_label: PHYSICS_STEPS_TIMED,
             "mjcf_quadruped_2048": MJCF_STEPS_TIMED,
             "quadruped_2048_fastM_generic": GENERIC_STEPS_TIMED,
             **{label: timed for label, (_, _, timed) in DISTILL_PATHS.items()}}
    for label, path in training_paths.items():
        counts = ", ".join(f"{name} {n}" for name, n in by_path[label].items())
        dict_reward = isinstance(path["state"].env_states.reward, dict)
        critic = "critic loss (tracking)" if dict_reward else "critic loss"
        print(
            f"{label} ({path['layout']}): {path['n_steps']} ppo_steps, launches: {counts}; actor "
            f"loss {path['actor_loss']:.5f}, {critic} {path['critic_loss']:.5f}"
        )
        print(
            f"{label}_sps {path['sps']:.1f} (step {path['step_ms']:.2f} ms over "
            f"{timed[label]} steps, shuffled; first call incl. set-up "
            f"{path['first_call_s']:.2f} s) on {card}"
        )
    for label, path in distill_paths.items():
        counts = ", ".join(f"{name} {n}" for name, n in by_path[label].items())
        print(f"{label} ({path['layout']}): {path['n_steps']} distillation_steps, launches: "
              f"{counts}; distillation NLL {path['nll'][0]:.5f} -> {path['nll'][1]:.5f}")
        print(f"{label}_sps {path['sps']:.1f} (step {path['step_ms']:.2f} ms over "
              f"{timed[label]} steps; first call incl. set-up {path['first_call_s']:.2f} s) on "
              f"{card}")
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
    for label, prof in new_path_profiles.items():
        print(f"{label}: {prof['device_kernels']} device kernels per ppo_step, device busy "
              f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f} on {card}")
    print(json.dumps({"kernel_vs_generic": kernel_vs_generic,
                      "engine_card_vs_cpu": engine_card_vs_cpu}))
    print(f"run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernel_rows.values())}))
    print(f"card: {card}")
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
