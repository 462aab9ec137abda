"""Train the arm to push a free ball to ground targets with PPO.

Port of the JAX package's ``examples/arm_pushing.py``. The
object-interaction flagship run (``envs/pusher.py`` on the multi-tree
scene layer, ``physics/scene.py``; each control step is one launch of
the scene kernel, ``csrc/scene_step.cu``, 16 substeps). Writes the eval
learning curve to ``nnx_ppo_tpu_torch/examples/results/pusher_curve.csv``.

    python -m nnx_ppo_tpu_torch.examples.arm_pushing [--total-steps N] [--cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from nnx_ppo_tpu_torch.envs import ArmPush
from nnx_ppo_tpu_torch.examples import arm_reaching

CSV_FIELDS = arm_reaching.CSV_FIELDS


def make_parser() -> argparse.ArgumentParser:
    parser = arm_reaching.make_parser(total_steps=30_000_000)
    parser.description = __doc__.splitlines()[0]
    return parser


def build(args: argparse.Namespace, device):
    """(env, networks, train_config) on ``device`` (raises for ``"cuda"``
    without a GPU); fills ``args.out``. The reacher's run with the
    pusher's env and a 200-step limit."""
    return arm_reaching.arm_run(args, device, ArmPush(), 200, "pusher_curve.csv")


def main(argv: Optional[Sequence[str]] = None) -> None:
    arm_reaching.run(make_parser(), build, argv)


if __name__ == "__main__":
    main()
