"""Train a multi-stream policy on JoystickLocomotion (dict obs/rewards).

Port of the JAX package's ``examples/joystick_locomotion.py``, the
"quadruped joystick" workload shape:

* dict observations routed to per-stream encoders (``Concat``),
* dict rewards with one critic head per key (``Parallel``) and
  team-summed advantages (``combine_advantages=True``),
* observation normalization on the proprio stream,
* data parallelism over the ranks when started by ``torchrun`` with more
  than one process (the JAX script takes a mesh over all visible chips
  when there is more than one): one process per card, NCCL.

    python -m nnx_ppo_tpu_torch.examples.joystick_locomotion [total_steps] [--cpu]
    torchrun --nproc_per_node=4 -m nnx_ppo_tpu_torch.examples.joystick_locomotion
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from nnx_ppo_tpu_torch.algorithms import EvalConfig, PPOConfig, TrainConfig, train_ppo
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.envs import JoystickLocomotion
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
from nnx_ppo_tpu_torch.parallel import distributed_initialize, make_mesh
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


def make_network(env: JoystickLocomotion, seed: int):
    g = torch.Generator().manual_seed(seed)
    encoder = Concat.create(
        proprio=Sequential.create(
            [
                Normalizer.create(env.observation_size["proprio"]),
                Dense.create(env.observation_size["proprio"], 128, g, torch.relu),
            ]
        ),
        command=Dense.create(env.observation_size["command"], 32, g, torch.relu),
    )
    actor = Sequential.create(
        [
            Dense.create(160, 128, g, torch.relu),
            Dense.create(128, 2 * env.action_size, g),
            NormalTanhSampler.create(entropy_weight=1e-3),
        ]
    )
    critic = Parallel.create(
        tracking=make_mlp([160, 128, 1], g, activation_last_layer=False),
        penalty=make_mlp([160, 128, 1], g, activation_last_layer=False),
    )
    return Sequential.create([encoder, PPOAdapter.create(action=actor, value=critic)])


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("total_steps", nargs="?", type=int, default=2_000_000)
    parser.add_argument("--cpu", action="store_true")
    return parser


def build(args: argparse.Namespace, device):
    """(env, networks, train_config) on ``device`` (raises for ``"cuda"``
    without a GPU)."""
    resolve_device(device)
    raw_env = JoystickLocomotion()
    env = EpisodeWrapper(raw_env, max_len=500)
    networks = make_network(raw_env, 0)
    config = TrainConfig(
        ppo=PPOConfig(
            n_envs=4096,
            rollout_length=20,
            total_steps=args.total_steps,
            learning_rate=3e-4,
            combine_advantages=True,
            steps_per_call=10,
        ),
        eval=EvalConfig(every_steps=500_000, n_envs=256, max_episode_length=500,
                        logging_percentiles=None),
    )
    return env, networks, config


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = make_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    env, networks, config = build(args, device)

    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # Started by torchrun with several processes: one rank each.
        distributed_initialize(backend="gloo" if args.cpu else "nccl")
        mesh = make_mesh(device="cpu" if args.cpu else None)

    def log_fn(metrics, step):
        tracked = metrics.get("episode_reward/tracking/mean")
        if tracked is not None:
            print(f"step {step:>10,}  eval tracking reward {float(tracked):8.2f}")

    try:
        result = train_ppo(env, networks, config, log_fn=log_fn, mesh=mesh,
                           device=None if mesh else device)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    print("final:", {k: v for k, v in result.final_metrics.items() if "episode" in k})


if __name__ == "__main__":
    main()
