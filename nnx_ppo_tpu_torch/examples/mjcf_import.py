"""Train a policy on a robot imported from MuJoCo MJCF XML.

Port of the JAX package's ``examples/mjcf_import.py``. The robot is
described the way a MuJoCo user would write it — free-floating trunk,
four 3-hinge legs with joint anchors, foot spheres, a ground plane —
then imported onto the port's engine with
:func:`nnx_ppo_tpu_torch.envs.legged_from_mjcf` and trained with the
standard :class:`~nnx_ppo_tpu_torch.envs.legged.LeggedJoystick` env (one
control-step kernel launch per env step, at the imported model's sizes).
The XML and the standing pose are ``physics/models/mjcf_quadruped.py``'s,
the port's copy of the JAX script's.

The import needs the ``mujoco`` package. ``--from-saved`` (an addition
of the port) builds the same env from the import saved beside that
module instead, for machines without ``mujoco``; without the flag and
without ``mujoco`` the script stops and names the flag.

    python -m nnx_ppo_tpu_torch.examples.mjcf_import [--steps N] [--from-saved] [--cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
from typing import Optional, Sequence

import torch

from nnx_ppo_tpu_torch.algorithms import EvalConfig, PPOConfig, TrainConfig, train_ppo
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.envs.legged import LeggedJoystick
from nnx_ppo_tpu_torch.networks import (
    Concat,
    Dense,
    NormalTanhSampler,
    Parallel,
    PPOAdapter,
    Sequential,
    make_mlp,
)
from nnx_ppo_tpu_torch.physics.models import mjcf_quadruped
from nnx_ppo_tpu_torch.physics.models.mjcf_quadruped import DEFAULT_POSE, QUADRUPED_MJCF
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


def make_env(from_saved: bool = False, **kwargs) -> LeggedJoystick:
    """Build the joystick env straight from the XML: kp and per-joint
    action scales come from the ``<position>`` actuators; the standing
    pose overrides the MJCF zero configuration. ``from_saved``: from the
    saved import of the same XML (no ``mujoco`` needed)."""
    if from_saved:
        return mjcf_quadruped.make_env(**kwargs)
    if importlib.util.find_spec("mujoco") is None:
        raise SystemExit(
            "mjcf_import: importing the MJCF needs the mujoco package, which is not "
            "installed; pass --from-saved to build the env from the saved import"
        )
    from nnx_ppo_tpu_torch.envs import legged_from_mjcf

    return legged_from_mjcf(
        QUADRUPED_MJCF,
        default_pose=DEFAULT_POSE,
        stand_height=0.312,
        **kwargs,
    )


def make_network(proprio: int, n_act: int, seed: int = 0):
    """The example's inline actor-critic (relu, encoder 128 + 32)."""
    g = torch.Generator().manual_seed(seed)
    enc = Concat.create(
        proprio=Dense.create(proprio, 128, g, torch.relu),
        command=Dense.create(3, 32, g, torch.relu),
    )
    actor = Sequential.create(
        [
            Dense.create(160, 128, g, torch.relu),
            Dense.create(128, 2 * n_act, g),
            NormalTanhSampler.create(entropy_weight=1e-3),
        ]
    )
    critic = Parallel.create(
        tracking=make_mlp([160, 128, 1], g, activation_last_layer=False),
        penalty=make_mlp([160, 128, 1], g, activation_last_layer=False),
    )
    return Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=2_000_000)
    parser.add_argument("--n-envs", type=int, default=1024)
    parser.add_argument("--from-saved", action="store_true",
                        help="build the env from the saved import of the XML "
                             "(physics/models/mjcf_quadruped.npz): no mujoco needed")
    parser.add_argument("--cpu", action="store_true")
    return parser


def build(args: argparse.Namespace, device):
    """(env, networks, train_config) on ``device`` (raises for ``"cuda"``
    without a GPU)."""
    resolve_device(device)
    env = EpisodeWrapper(make_env(args.from_saved, reuse_mass_matrix=True), max_len=500)
    net = make_network(env.observation_size["proprio"], env.action_size)
    cfg = TrainConfig(
        ppo=PPOConfig(
            n_envs=args.n_envs,
            rollout_length=20,
            total_steps=args.steps,
            combine_advantages=True,
        ),
        eval=EvalConfig(n_envs=256, logging_percentiles=None),
    )
    return env, net, cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = make_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    env, net, cfg = build(args, device)
    res = train_ppo(
        env,
        net,
        cfg,
        log_fn=lambda metrics, step: print(
            step,
            {
                k_: round(float(v), 3)
                for k_, v in metrics.items()
                if "episode_reward" in k_ or "lifespan_mean" in k_
            },
        ),
        device=device,
    )
    print("final eval:", res.eval_history[-1])


if __name__ == "__main__":
    main()
