"""Train a legged robot (in-repo rigid-body physics) with PPO.

Port of the JAX package's ``examples/legged_training.py``. The
contact-rich flagship run: quadruped (default) or humanoid, penalty
contacts, dict obs/rewards, obs normalization, team-summed advantages.
Each control step is one launch of the control-step kernel
(``csrc/control_step.cu``), after one plane-sampler launch on a
``--hfield`` terrain. Writes the eval learning curve to
``nnx_ppo_tpu_torch/examples/results/{env}_curve.csv``.

    python -m nnx_ppo_tpu_torch.examples.legged_training [--env humanoid]
        [--total-steps N] [--cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from nnx_ppo_tpu_torch.algorithms import EvalConfig, PPOConfig, TrainConfig, train_ppo
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.envs import HumanoidJoystick, QuadrupedJoystick
from nnx_ppo_tpu_torch.examples import results_path, write_csv
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

CSV_FIELDS = ("step", "tracking", "penalty", "lifespan")


def _encoder(obs_spec, generator: torch.Generator, *, privileged: bool):
    """Concat encoder over the obs streams; ``privileged`` controls
    whether the DR-draw stream is consumed (Concat children index the
    obs dict by name, so extra keys are simply ignored)."""
    streams = dict(
        proprio=Dense.create(obs_spec["proprio"], 256, generator, F.silu),
        command=Dense.create(obs_spec["command"], 32, generator, F.silu),
    )
    width = 288
    if "height_scan" in obs_spec:
        streams["height_scan"] = Dense.create(obs_spec["height_scan"], 64, generator, F.silu)
        width += 64
    if privileged:
        streams["privileged"] = Dense.create(obs_spec["privileged"], 16, generator, F.silu)
        width += 16
    return Concat.create(**streams), width


def make_net(obs_spec, action_size: int, seed: int, asymmetric: bool = False):
    """Actor-critic for the legged envs. With ``asymmetric=True`` (and a
    ``privileged`` obs stream from ``privileged_obs=True``) the critic
    gets its own encoder consuming the per-episode DR draw while the
    actor stays blind to it — asymmetric actor-critic: the value
    function conditions on sim-only physics truth, the policy remains
    deployable. Weights are drawn from a generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    asymmetric = asymmetric and "privileged" in obs_spec

    def actor_head(width):
        return [
            Dense.create(width, 128, g, F.silu),
            Dense.create(128, 2 * action_size, g),
            NormalTanhSampler.create(entropy_weight=2e-3, min_std=0.1),
        ]

    def critic_head(width):
        return Parallel.create(
            tracking=make_mlp([width, 256, 1], g, F.silu, activation_last_layer=False),
            penalty=make_mlp([width, 256, 1], g, F.silu, activation_last_layer=False),
        )

    if asymmetric:
        enc_a, width_a = _encoder(obs_spec, g, privileged=False)
        enc_c, width_c = _encoder(obs_spec, g, privileged=True)
        adapter = PPOAdapter.create(
            action=Sequential.create([enc_a, *actor_head(width_a)]),
            value=Sequential.create([enc_c, critic_head(width_c)]),
        )
        return Sequential.create([Normalizer.create(obs_spec), adapter])
    enc, width = _encoder(obs_spec, g, privileged=False)
    return Sequential.create([
        Normalizer.create(obs_spec),
        enc,
        PPOAdapter.create(action=Sequential.create(actor_head(width)), value=critic_head(width)),
    ])


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--env", choices=["quadruped", "humanoid"], default="quadruped")
    parser.add_argument("--total-steps", type=int, default=60_000_000)
    parser.add_argument("--n-envs", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--fast-mass-matrix", action="store_true",
                        help="hold the Cholesky factor of M over each control step "
                             "(faster, a tiny integration approximation)")
    parser.add_argument("--full-contact", action="store_true",
                        help="enable foot self-collision pairs and joint-range stops "
                             "(the full contact model; slower per step)")
    parser.add_argument("--rough", action="store_true",
                        help="rough heightfield ground (physics/terrain.py) + a 5x5 "
                             "height-scan obs stream so the policy sees upcoming bumps")
    parser.add_argument("--stairs", action="store_true",
                        help="smooth staircase ground (terrain.stairs) + height scan — "
                             "the classic stair-climbing benchmark surface")
    parser.add_argument("--hfield", action="store_true",
                        help="sample the chosen terrain (--rough/--stairs) into a "
                             "HeightGrid: trains on DATA terrain (the MJCF-hfield "
                             "workload) through the plane-sampler kernel")
    parser.add_argument("--randomize", action="store_true",
                        help="per-episode domain randomization (mass/friction/damping/"
                             "gain — physics/randomize.py)")
    parser.add_argument("--privileged", action="store_true",
                        help="asymmetric actor-critic: critic observes the DR draw "
                             "(implies --randomize)")
    parser.add_argument("--obs-noise", type=float, default=0.0,
                        help="sensor-noise std on proprio/height_scan")
    parser.add_argument("--push", action="store_true",
                        help="random trunk pushes (disturbance rejection: 80 N, "
                             "p=0.05 per control step)")
    parser.add_argument("--out", default=None)
    return parser


def default_out(args: argparse.Namespace) -> str:
    suffix = ("_full" if args.full_contact else "") + ("_rough" if args.rough else "") + (
        "_stairs" if args.stairs else ""
    ) + ("_hfield" if args.hfield else "") + ("_dr" if args.randomize else "") + (
        "_priv" if args.privileged else ""
    )
    return results_path(f"{args.env}{suffix}_curve.csv")


def build(args: argparse.Namespace, device):
    """(env, networks, train_config) of the run ``args`` asks for, on
    ``device`` (raises for ``"cuda"`` without a GPU). Fills ``args.out``
    and, for ``--privileged``, ``args.randomize`` as the JAX script does."""
    resolve_device(device)
    if args.out is None:
        args.out = default_out(args)
    env_cls = QuadrupedJoystick if args.env == "quadruped" else HumanoidJoystick
    extra = {}
    if args.rough:
        from nnx_ppo_tpu_torch.physics import rough_terrain

        extra = dict(terrain=rough_terrain(seed=2, amplitude=0.03, wavelength=1.5),
                     height_scan=5)
    elif args.stairs:
        from nnx_ppo_tpu_torch.physics import stairs

        extra = dict(terrain=stairs(step_height=0.06, step_length=0.4), height_scan=5)
    if args.hfield:
        if "terrain" not in extra:
            raise SystemExit("--hfield needs --rough or --stairs")
        from nnx_ppo_tpu_torch.physics import HeightGrid

        extra["terrain"] = HeightGrid.sample(extra["terrain"], extent=12.0, n=256)
    if args.privileged:
        args.randomize = True
    if args.randomize:
        from nnx_ppo_tpu_torch.physics import DomainRandomization

        extra["randomize"] = DomainRandomization(
            mass_scale=(0.8, 1.2),
            friction=(0.4, 1.0),
            damping_scale=(0.9, 1.1),
            gain_scale=(0.9, 1.1),
        )
        extra["privileged_obs"] = args.privileged
    if args.obs_noise > 0.0:
        extra["obs_noise"] = args.obs_noise
    if args.push:
        extra["push_prob"] = 0.05
        extra["push_force"] = 80.0
    inner = env_cls(
        reuse_mass_matrix=args.fast_mass_matrix,
        self_collision=args.full_contact,
        joint_limits=args.full_contact,
        **extra,
    )
    env = EpisodeWrapper(inner, max_len=500)
    net = make_net(inner.observation_size, inner.action_size, args.seed,
                   asymmetric=args.privileged)
    cfg = TrainConfig(
        ppo=PPOConfig(
            n_envs=args.n_envs,
            rollout_length=20,
            total_steps=args.total_steps,
            learning_rate=3e-4,
            n_epochs=4,
            n_minibatches=4,
            gradient_clipping=1.0,
            combine_advantages=True,
            steps_per_call=5,
        ),
        eval=EvalConfig(
            every_steps=max(args.total_steps // 30, 1),
            n_envs=128,
            max_episode_length=500,
            logging_percentiles=None,
        ),
        seed=args.seed,
    )
    return env, net, cfg


def curve_rows(eval_history) -> list[dict]:
    """The CSV rows of an eval history (JAX ``legged_training.py:251-259``)."""
    return [
        {
            "step": entry["step"],
            "tracking": round(float(entry["episode_reward/tracking/mean"]), 3),
            "penalty": round(float(entry["episode_reward/penalty/mean"]), 3),
            "lifespan": round(float(entry["lifespan_mean"]), 1),
        }
        for entry in eval_history
    ]


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = make_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    env, net, cfg = build(args, device)

    t0 = time.perf_counter()
    result = train_ppo(env, net, cfg, device=device)
    wall = time.perf_counter() - t0

    rows = curve_rows(result.eval_history)
    for row in rows:
        print(row, flush=True)
    write_csv(args.out, CSV_FIELDS, rows)
    total = cfg.ppo.total_steps
    print(f"done: {total} steps in {wall:.0f}s = {total / wall:,.0f} sps", flush=True)


if __name__ == "__main__":
    main()
