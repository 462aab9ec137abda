"""Record CartpoleBalance learning curves to CSV.

Port of the JAX package's ``examples/learning_curves.py``: per-eval CSV
rows (impl, step, reward mean/std) at brax-matched hyperparameters
(rollout-length scaling ``unroll·(batch·minibatches/envs)`` and
``critic_loss_weight=0.5`` to match brax's 0.25·MSE). The JAX script
also runs brax where it is installed; brax is a JAX library, so this
one records only the port's curve (``impl`` ``nnx_ppo_tpu_torch``).

    python -m nnx_ppo_tpu_torch.examples.learning_curves [out.csv] [--cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from nnx_ppo_tpu_torch.algorithms import (
    EvalConfig,
    PPOConfig,
    TrainConfig,
    VideoConfig,
    train_ppo,
)
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.examples import results_path, write_csv
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

NUM_ENVS = 512
UNROLL_LENGTH = 5
BATCH_SIZE = 256
NUM_MINIBATCHES = 8
# Match brax's effective rollout length.
ROLLOUT_LENGTH = UNROLL_LENGTH * (BATCH_SIZE * NUM_MINIBATCHES // NUM_ENVS)
TOTAL_STEPS = 5_000_000
SEED = 17
IMPL = "nnx_ppo_tpu_torch"
CSV_FIELDS = ("impl", "step", "reward_mean", "reward_std")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out", nargs="?", default=results_path("learning_curves.csv"))
    parser.add_argument("--cpu", action="store_true")
    return parser


def build(args: argparse.Namespace, device, total_steps: int = TOTAL_STEPS, seed: int = SEED):
    """(env, networks, train_config) of the run (JAX ``run_ours``), on
    ``device`` (raises for ``"cuda"`` without a GPU)."""
    resolve_device(device)
    env = EpisodeWrapper(CartpoleBalance(), max_len=500)
    networks = make_mlp_actor_critic(
        env.observation_size,
        env.action_size,
        [32, 32, 32, 32],
        [256, 256, 256, 256, 256],
        seed,
        entropy_weight=1e-2,
    )
    config = TrainConfig(
        ppo=PPOConfig(
            n_envs=NUM_ENVS,
            rollout_length=ROLLOUT_LENGTH,
            total_steps=total_steps,
            learning_rate=3e-4,
            n_epochs=4,
            n_minibatches=NUM_MINIBATCHES,
            critic_loss_weight=0.5,  # brax uses 0.25·MSE ≡ 0.5·(0.5·MSE)
        ),
        eval=EvalConfig(
            n_envs=128, max_episode_length=500, every_steps=total_steps // 20,
            logging_percentiles=None,
        ),
        video=VideoConfig(enabled=False),
        seed=seed,
    )
    return env, networks, config


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = make_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    env, networks, config = build(args, device)
    result = train_ppo(env, networks, config, device=device)
    rows = [(h["step"], h["episode_reward/mean"], h["episode_reward/std"])
            for h in result.eval_history]
    write_csv(args.out, CSV_FIELDS, (dict(zip(CSV_FIELDS, (IMPL, *row))) for row in rows))
    print(f"wrote {len(rows)} rows to {args.out}")
    print("final:", rows[-1])


if __name__ == "__main__":
    main()
