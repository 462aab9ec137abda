"""Policy distillation on the contact-rich quadruped: train a teacher
with PPO, then distill it into a half-width student (Rusu-2015, the
distillation capability exercised on real articulated physics instead
of cartpole).

Port of the JAX package's ``examples/distill_quadruped.py``. Both phases
step the quadruped with its factor held over each control step: one
control-step kernel launch per env step (``csrc/control_step.cu``).

    python -m nnx_ppo_tpu_torch.examples.distill_quadruped [--teacher-steps N]
        [--distill-steps N] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from nnx_ppo_tpu_torch.algorithms import (
    EvalConfig,
    PPOConfig,
    TrainConfig,
    train_distillation,
    train_ppo,
)
from nnx_ppo_tpu_torch.algorithms.distillation import default_distillation_config
from nnx_ppo_tpu_torch.algorithms.rollout import eval_rollout
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.envs import QuadrupedJoystick
from nnx_ppo_tpu_torch.examples.legged_training import make_net
from nnx_ppo_tpu_torch.networks import (
    Concat,
    Dense,
    NormalTanhSampler,
    Normalizer,
    Parallel,
    PPOAdapter,
    Sequential,
    make_mlp,
)
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


def small_net(seed: int, obs_spec: dict, action_size: int):
    """Half-width student with the same structure (isomorphic
    state/extras trees are required by the distillation contract).
    ``obs_spec`` and ``action_size`` are the quadruped's (JAX reads them
    from ``QuadrupedJoystick``'s class attributes; here they are set per
    env)."""
    g = torch.Generator().manual_seed(seed)
    enc = Concat.create(
        proprio=Dense.create(obs_spec["proprio"], 128, g, F.silu),
        command=Dense.create(obs_spec["command"], 16, g, F.silu),
    )
    actor = Sequential.create([
        Dense.create(144, 64, g, F.silu),
        Dense.create(64, 2 * action_size, g),
        NormalTanhSampler.create(entropy_weight=2e-3, min_std=0.1),
    ])
    critic = Parallel.create(
        tracking=make_mlp([144, 128, 1], g, F.silu, activation_last_layer=False),
        penalty=make_mlp([144, 128, 1], g, F.silu, activation_last_layer=False),
    )
    return Sequential.create([
        Normalizer.create(obs_spec),
        enc,
        PPOAdapter.create(action=actor, value=critic),
    ])


def eval_tracking(env, net, n_envs: int = 128, length: int = 500) -> float:
    """Mean tracking reward of ``net`` in eval mode over fresh episodes,
    with its own generator (seed 123) on the net's device."""
    device = next(net.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(123)
    net.eval()
    try:
        metrics = eval_rollout(env, net, n_envs, length, generator)
    finally:
        net.train()
    return float(metrics["episode_reward/tracking/mean"])


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--teacher-steps", type=int, default=30_000_000)
    parser.add_argument("--distill-steps", type=int, default=10_000_000)
    parser.add_argument("--n-envs", type=int, default=2048)
    parser.add_argument("--cpu", action="store_true")
    return parser


def build(args: argparse.Namespace, device):
    """(env, (teacher, student), (teacher's TrainConfig, the
    DistillationTrainConfig)) on ``device`` (raises for ``"cuda"``
    without a GPU)."""
    resolve_device(device)
    inner = QuadrupedJoystick(reuse_mass_matrix=True)
    env = EpisodeWrapper(inner, max_len=500)
    teacher = make_net(inner.observation_size, inner.action_size, 0)
    student = small_net(1, inner.observation_size, inner.action_size)
    cfg = TrainConfig(
        ppo=PPOConfig(
            n_envs=args.n_envs, rollout_length=20, total_steps=args.teacher_steps,
            learning_rate=3e-4, n_epochs=4, n_minibatches=4, gradient_clipping=1.0,
            combine_advantages=True, steps_per_call=5,
        ),
        eval=EvalConfig(enabled=False),
    )
    d_cfg = default_distillation_config()
    d_cfg = dataclasses.replace(
        d_cfg,
        distillation=dataclasses.replace(
            d_cfg.distillation, n_envs=args.n_envs, total_steps=args.distill_steps
        ),
    )
    return env, (teacher, student), (cfg, d_cfg)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train, distill and print; returns the teacher's and the student's
    tracking and the recovery (student over teacher, %)."""
    args = make_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    env, (teacher, student), (cfg, d_cfg) = build(args, device)

    t0 = time.perf_counter()
    result = train_ppo(env, teacher, cfg, device=device)
    teacher = result.training_state.networks
    t_reward = eval_tracking(env, teacher)
    print(f"teacher: tracking {t_reward:.1f} ({time.perf_counter() - t0:.0f}s)", flush=True)

    t0 = time.perf_counter()
    d_result = train_distillation(env, teacher, student, d_cfg, device=device)
    student = d_result.training_state.student
    s_reward = eval_tracking(env, student)
    print(f"student: tracking {s_reward:.1f} after distillation "
          f"({time.perf_counter() - t0:.0f}s)", flush=True)
    recovery = 100 * s_reward / max(t_reward, 1e-6)
    print(f"recovery: {recovery:.1f}%", flush=True)
    return dict(teacher_tracking=t_reward, student_tracking=s_reward, recovery=recovery)


if __name__ == "__main__":
    main()
