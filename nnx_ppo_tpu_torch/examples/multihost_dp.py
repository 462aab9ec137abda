"""Data-parallel PPO over one or more hosts' cards.

Port of the JAX package's ``examples/multihost_dp.py``: a 1-D ``data``
mesh over the ranks of a ``torch.distributed`` process group, one
process per card; envs, carries and rollout buffers split over the
ranks, parameters replicated, gradients and normalizer statistics
reduced by collectives (``parallel/mesh.py``).

The port's ``make_mesh`` needs a process group. Run alone (no
``--distributed``), this script starts a one-process group itself
(NCCL on the card, gloo with ``--cpu``), so that the mesh has world size
1, as JAX's one-device mesh does on one chip.

One host, one card (a one-process group of its own):
    python -m nnx_ppo_tpu_torch.examples.multihost_dp
One host, N cards, or several hosts (torchrun sets the address, rank
and world size):
    torchrun --nproc_per_node=N -m nnx_ppo_tpu_torch.examples.multihost_dp --distributed
CPU smoke test:
    python -m nnx_ppo_tpu_torch.examples.multihost_dp --cpu --n-envs 64 --total-steps 10000
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from nnx_ppo_tpu_torch.algorithms import (
    EvalConfig,
    LoggingLevel,
    PPOConfig,
    TrainConfig,
    VideoConfig,
    train_ppo,
)
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.parallel import distributed_initialize, make_mesh
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--n-envs", type=int, default=8192)
    parser.add_argument("--total-steps", type=int, default=20_000_000)
    parser.add_argument("--cpu", action="store_true")
    return parser


def build(args: argparse.Namespace, device):
    """(env, networks, train_config) on ``device`` (raises for ``"cuda"``
    without a GPU)."""
    resolve_device(device)
    env = EpisodeWrapper(CartpoleBalance(), max_len=500)
    networks = make_mlp_actor_critic(
        env.observation_size,
        env.action_size,
        [64, 64, 64, 64],
        [256, 256],
        0,
        entropy_weight=1e-3,
    )
    config = TrainConfig(
        ppo=PPOConfig(
            n_envs=args.n_envs,
            rollout_length=30,
            total_steps=args.total_steps,
            learning_rate=3e-4,
            logging_level=LoggingLevel.BASIC | LoggingLevel.THROUGHPUT,
        ),
        eval=EvalConfig(n_envs=256, max_episode_length=500,
                        every_steps=args.total_steps // 4),
        video=VideoConfig(enabled=False),
    )
    return env, networks, config


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = make_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    env, networks, config = build(args, device)
    backend = "gloo" if args.cpu else "nccl"
    if args.distributed:
        distributed_initialize(backend=backend)
    else:
        # A one-process group: make_mesh() then gives world size 1.
        distributed_initialize(backend=backend, store=torch.distributed.HashStore(),
                               rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu" if args.cpu else None)  # 1-D 'data' axis over the ranks
        print(f"mesh: {mesh.shape} ({mesh.world_size} devices)")
        result = train_ppo(
            env,
            networks,
            config,
            mesh=mesh,
            log_fn=lambda m, s: print(
                s, {k: float(v) for k, v in m.items() if "throughput" in k}
            ),
        )
    finally:
        torch.distributed.destroy_process_group()
    print("final eval:", result.eval_history[-1])


if __name__ == "__main__":
    main()
