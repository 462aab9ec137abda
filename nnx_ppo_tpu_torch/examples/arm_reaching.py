"""Train the ball-shoulder manipulator to reach 3-D targets with PPO.

Port of the JAX package's ``examples/arm_reaching.py``. The
manipulation-family flagship run (``envs/reacher.py`` on the in-repo
engine's ball joint; each control step is one launch of the scene
kernel, ``csrc/scene_step.cu``). Writes the eval learning curve to
``nnx_ppo_tpu_torch/examples/results/reacher_curve.csv``.

    python -m nnx_ppo_tpu_torch.examples.arm_reaching [--total-steps N] [--cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from nnx_ppo_tpu_torch.algorithms import EvalConfig, PPOConfig, TrainConfig, train_ppo
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.envs import ArmReacher
from nnx_ppo_tpu_torch.examples import results_path, write_csv
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

CSV_FIELDS = ("step", "reward")


def make_parser(total_steps: int = 20_000_000) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--total-steps", type=int, default=total_steps)
    parser.add_argument("--n-envs", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--out", default=None)
    return parser


def arm_run(args: argparse.Namespace, device, inner, max_len: int, curve: str):
    """(env, networks, train_config) of an arm run on ``inner`` with a
    ``max_len`` time limit (shared with ``arm_pushing``)."""
    resolve_device(device)
    if args.out is None:
        args.out = results_path(curve)
    env = EpisodeWrapper(inner, max_len=max_len)
    net = make_mlp_actor_critic(
        env.observation_size,
        env.action_size,
        [128, 128],
        [256, 256],
        args.seed,
        entropy_weight=2e-3,
        normalize_obs=True,
    )
    cfg = TrainConfig(
        ppo=PPOConfig(
            n_envs=args.n_envs,
            rollout_length=20,
            total_steps=args.total_steps,
            learning_rate=3e-4,
            n_epochs=4,
            n_minibatches=4,
            gradient_clipping=1.0,
            steps_per_call=5,
        ),
        eval=EvalConfig(
            every_steps=max(args.total_steps // 25, 1),
            n_envs=128,
            max_episode_length=max_len,
            logging_percentiles=None,
        ),
        seed=args.seed,
    )
    return env, net, cfg


def build(args: argparse.Namespace, device):
    """(env, networks, train_config) on ``device`` (raises for ``"cuda"``
    without a GPU); fills ``args.out``."""
    return arm_run(args, device, ArmReacher(), 150, "reacher_curve.csv")


def curve_rows(eval_history) -> list[dict]:
    return [
        {"step": entry["step"], "reward": round(float(entry["episode_reward/mean"]), 3)}
        for entry in eval_history
    ]


def run(parser: argparse.ArgumentParser, build_fn, argv: Optional[Sequence[str]]) -> None:
    """``main`` of an arm script: ``argv`` parsed by its ``parser``, its
    run built by ``build_fn`` and trained, then the curve printed and
    written (shared with ``arm_pushing``)."""
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    env, net, cfg = build_fn(args, device)

    t0 = time.perf_counter()
    result = train_ppo(env, net, cfg, device=device)
    wall = time.perf_counter() - t0

    rows = curve_rows(result.eval_history)
    for row in rows:
        print(row, flush=True)
    write_csv(args.out, CSV_FIELDS, rows)
    total = cfg.ppo.total_steps
    print(f"done: {total} steps in {wall:.0f}s = {total / wall:,.0f} sps", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(make_parser(), build, argv)


if __name__ == "__main__":
    main()
