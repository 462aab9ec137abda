"""Train CartpoleBalance with Weights & Biases logging + videos.

Port of the JAX package's ``examples/wandb_logging.py``: 1024 envs ×
rollout 30, periodic eval, the video callback
(:func:`~nnx_ppo_tpu_torch.algorithms.wandb_video_fn`). Logs to stdout
when wandb is not installed, as the JAX script does.

    python -m nnx_ppo_tpu_torch.examples.wandb_logging [--cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from nnx_ppo_tpu_torch.algorithms import (
    EvalConfig,
    LoggingLevel,
    PPOConfig,
    TrainConfig,
    VideoConfig,
    train_ppo,
    wandb_video_fn,
)
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
        actor_hidden_sizes=[64, 64, 64, 64],
        critic_hidden_sizes=[256, 256],
        seed=0,
        entropy_weight=1e-3,
    )
    config = TrainConfig(
        ppo=PPOConfig(
            n_envs=1024,
            rollout_length=30,
            total_steps=10_000_000,
            learning_rate=3e-4,
            logging_level=LoggingLevel.BASIC | LoggingLevel.THROUGHPUT,
        ),
        eval=EvalConfig(n_envs=128, max_episode_length=500, every_steps=1_000_000),
        video=VideoConfig(enabled=False),
    )
    return env, networks, config


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = make_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    try:
        import wandb

        wandb.init(project="nnx-ppo-tpu", name="cartpole-balance")
        log_fn = lambda metrics, step: wandb.log(dict(metrics), step=step)  # noqa: E731
        video_fn = wandb_video_fn()
    except ImportError:
        print("wandb not installed — logging to stdout")
        log_fn = lambda metrics, step: print(  # noqa: E731
            step,
            {
                k: round(float(v), 4)
                for k, v in metrics.items()
                if hasattr(v, "shape") and v.shape == () or isinstance(v, float)
            },
        )
        video_fn = None

    env, networks, config = build(args, device)
    result = train_ppo(env, networks, config, log_fn=log_fn, video_fn=video_fn, device=device)
    print("final eval:", result.eval_history[-1])


if __name__ == "__main__":
    main()
