#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nnx_ppo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit, from nvidia-smi;
2. build: every hand-written kernel of the training path, compiled with
   nvcc from the sources in nnx_ppo_tpu_torch/csrc/;
3. kernels: each kernel against its plain PyTorch version on the card at
   the training path's shapes (and a ragged one), then timed with CUDA
   events against the plain version;
4. path: the flagship training step at its full width (CartpoleBalance
   with a 500-step time limit, 1024 envs, T=30, actor 64x4, critic
   256x2, obs normalization, 4 epochs x 4 shuffled minibatches, adam)
   through new_training_state and ppo_multi_step, with every kernel's
   launch count set to 0 just before and read just after;
5. reference: the PPO loss and its gradients on the card against the
   same computation on the CPU (plain versions) for one minibatch.

It prints a ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``. With no CUDA device it exits 1 and
prints no result. ``--profile DIR`` also writes a torch.profiler table
of one training step to DIR; ``--learn N`` also trains the flagship for
N iterations through train_ppo and prints its eval curve.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

FLAGSHIP_STEPS_CHECKED = 3
FLAGSHIP_STEPS_TIMED = 10


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


def device_ms_per_call(fn, n: int, kernel_name: str, torch) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel_name``, from torch.profiler over ``n`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel_name in e.key]
    count = sum(e.count for e in events)
    if count != n:
        raise RuntimeError(f"profiler saw {count} launches of {kernel_name}, expected {n}")
    return sum(e.self_device_time_total for e in events) / count / 1e3


def gae_inputs(T: int, B: int, seed: int, device, torch):
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
    return [torch.tensor(a, device=device) for a in arrays]


def kernel_phase(torch) -> dict:
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda, gae_scan

    lam, gamma = 0.95, 0.99
    max_err = 0.0
    for i, (T, B) in enumerate([(30, 256), (30, 1024), (7, 1000)]):
        args = gae_inputs(T, B, seed=i, device="cuda", torch=torch)
        check(bool(args[3].any() and args[4].any()), "done and truncation flags are set")
        got = gae_cuda(*args, lam, gamma)
        want = gae_scan(*args, lam, gamma)
        torch.cuda.synchronize()
        # float32; both round every product and sum on its own.
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        print(f"gae [{T}, {B}]: max_abs_err {err:.3g} (rtol 1e-6, atol 1e-6)")

    # The training path's shape: one minibatch, T=30, B=1024/4.
    T, B = 30, 256
    args = gae_inputs(T, B, seed=0, device="cuda", torch=torch)
    ms = time_ms(lambda: gae_cuda(*args, lam, gamma), 500, torch)
    kernel_device_ms = device_ms_per_call(
        lambda: gae_cuda(*args, lam, gamma), 100, "gae_kernel", torch
    )
    plain_ms = time_ms(lambda: gae_scan(*args, lam, gamma), 50, torch)
    n_bytes = (5 * T + 1) * B * 4
    n_flops = 10 * T * B
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S)
    bound_by = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_flops / FP32_FLOPS_PER_S else "operations"
    return {
        "name": "gae",
        "route": "cuda",
        "source": "nnx_ppo_tpu_torch/csrc/gae.cu",
        "replaces": "nnx_ppo_tpu/ops/gae.py:105",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes GAE
        "shape": [T, B],
        "kernel_device_ms": kernel_device_ms,
    }


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


def path_phase(torch, kernels: dict, profile_dir: str | None) -> dict:
    from nnx_ppo_tpu_torch.algorithms import new_training_state, ppo_multi_step, ppo_step
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
    for name, v in history.items():
        check(bool(torch.isfinite(torch.as_tensor(v)).all()), f"{name} is finite")

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
    for name, v in history.items():
        check(bool(torch.isfinite(torch.as_tensor(v)).all()), f"{name} is finite")

    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

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
        step_ms = timed_s / FLAGSHIP_STEPS_TIMED * 1e3
        print(
            f"profile: {n_launches} device kernels, device busy {busy_ms:.2f} ms per "
            f"ppo_step; unprofiled step {step_ms:.2f} ms; device idle share "
            f"{1 - busy_ms / step_ms:.3f}"
        )
        path = os.path.join(profile_dir, "flagship_ppo_step_profile.txt")
        with open(path, "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))
            f.write("\n")
            f.write(prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))
        print(f"profile: {path}")

    return {
        "launches": launches,
        "first_call_s": first_s,
        "train_sps_first_call": FLAGSHIP_STEPS_CHECKED * per_step / first_s,
        "step_ms": timed_s / FLAGSHIP_STEPS_TIMED * 1e3,
        "train_sps": FLAGSHIP_STEPS_TIMED * per_step / timed_s,
        "state": ts,
        "actor_loss": float(history["losses/actor/mean"][-1]),
        "critic_loss": float(history["losses/critic/mean"][-1]),
    }


def reference_phase(torch, ts) -> float:
    """Loss and gradients on the card (GAE kernel) against the CPU (plain
    GAE) for one full-width minibatch of a fresh rollout."""
    from nnx_ppo_tpu_torch.algorithms import ppo_loss
    from nnx_ppo_tpu_torch.algorithms.ppo import ReplayMinibatch
    from nnx_ppo_tpu_torch.algorithms.rollout import unroll_env
    from nnx_ppo_tpu_torch.core.struct import tree_map
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda

    env, _, config, _ = flagship(torch)
    net_gpu = ts.networks
    with torch.no_grad():
        _, _, rollout = unroll_env(
            env, ts.env_states, net_gpu, ts.network_states, config.rollout_length, ts.generator
        )
    sel = torch.arange(256, device="cuda")
    view = ReplayMinibatch.from_rollout(rollout).gather(sel, lambda x, s: x[:, s], lambda x, s: x[s])
    kw = dict(
        clip_range=config.clip_range,
        normalize_advantages=True,
        combine_advantages=False,
        discounting_factor=config.discounting_factor,
        gae_lambda=config.gae_lambda,
        critic_loss_weight=1.0,
        logging_level=config.logging_level,
    )
    net_cpu = copy.deepcopy(net_gpu).cpu()
    view_cpu = tree_map(lambda x: x.cpu(), view)
    before = gae_cuda.launches
    net_gpu.zero_grad(set_to_none=True)
    loss_gpu, _ = ppo_loss(net_gpu, tree_map(lambda x: x[:256], ts.network_states), view, **kw)
    loss_gpu.backward()
    check(gae_cuda.launches == before + 1, "the loss on the card launched the GAE kernel")
    loss_cpu, _ = ppo_loss(net_cpu, tree_map(lambda x: x[:256].cpu(), ts.network_states), view_cpu, **kw)
    loss_cpu.backward()
    # float32 on both; sums over 7680 samples in another order.
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, rtol=1e-4, atol=1e-5)
    max_rel = 0.0
    for p_gpu, p_cpu in zip(net_gpu.parameters(), net_cpu.parameters()):
        torch.testing.assert_close(p_gpu.grad.cpu(), p_cpu.grad, rtol=1e-3, atol=1e-5)
        scale = p_cpu.grad.abs().max().clamp(min=1e-12)
        max_rel = max(max_rel, ((p_gpu.grad.cpu() - p_cpu.grad).abs().max() / scale).item())
    net_gpu.zero_grad(set_to_none=True)
    print(f"reference: loss cuda {loss_gpu.item():.6f} cpu {loss_cpu.item():.6f}; "
          f"max grad diff / max |grad| {max_rel:.3g}")
    return abs(loss_gpu.item() - loss_cpu.item())


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
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nnx_ppo_tpu_torch.ops import cuda_build
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda

    card = card_line()
    print(f"card: {card}")

    t0 = time.perf_counter()
    cuda_build.build(["gae"])
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")

    kernel = kernel_phase(torch)
    path = path_phase(torch, [gae_cuda], args.profile)
    kernel["launches"] = path["launches"]["gae_cuda"]
    reference_phase(torch, path["state"])
    if args.learn:
        learning_phase(torch, args.learn)

    print(
        f"flagship: {FLAGSHIP_STEPS_CHECKED + FLAGSHIP_STEPS_TIMED} ppo_steps, "
        f"gae launches {kernel['launches']}, actor loss {path['actor_loss']:.5f}, "
        f"critic loss {path['critic_loss']:.5f}"
    )
    print(
        f"train_sps {path['train_sps']:.1f} (step {path['step_ms']:.2f} ms over "
        f"{FLAGSHIP_STEPS_TIMED} steps; first call incl. set-up "
        f"{path['train_sps_first_call']:.1f}) on {card}"
    )
    print(json.dumps({"kernels": [kernel]}))
    print(f"card: {card}")
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
