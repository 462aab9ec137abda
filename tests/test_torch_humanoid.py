"""HumanoidJoystick parity: the port's humanoid model and batched env
against the JAX package's, with the JAX draws injected, and the humanoid
leg through ``ppo_step`` on the CPU.

The JAX env runs its SoA path: the lane functions of
``nnx_ppo_tpu/physics/engine_soa.py`` (``crba_chol_soa`` and
``substep_soa``), which the port's plain control step repeats. They run
through :func:`jax_lane_runner`, the body of ``run_one`` in
``nnx_ppo_tpu/physics/pallas_step.py::make_control_step_runner`` without
its ``custom_vmap`` / ``custom_partitioning`` wrapper, whose eager call
costs some 7 s per env step on the CPU; the draws repeat the JAX env's key
splits (``nnx_ppo_tpu/envs/legged.py:665-700, 816-822``), as
``tests/test_torch_legged.py`` does.

Tolerances: the model is numpy on both sides, equal to the bit; reset is
elementwise float32, 1e-6. Two env steps of two substeps each, chained on
each side from its own state: qpos 2e-4 and qvel 2e-3 (the quadruped's
for one step of two substeps, ``test_torch_legged.py``; the humanoid's
PD gain is 350 against 60; the measured gaps, under 3e-7 in qpos and
5e-5 in qvel after the second step, leave room for it), obs 2e-3 (it holds qvel), rewards
1e-4, contact force rtol 5e-3 / atol 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.envs import HumanoidJoystick as JaxHumanoidJoystick
from nnx_ppo_tpu.physics.engine_soa import crba_chol_soa as jax_crba_chol_soa
from nnx_ppo_tpu.physics.engine_soa import substep_soa as jax_substep_soa
from nnx_ppo_tpu.physics.models.humanoid import default_qpos as jax_default_qpos
from nnx_ppo_tpu.physics.models.humanoid import make_humanoid as jax_make_humanoid
from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer, new_training_state, ppo_step
from nnx_ppo_tpu_torch.envs import HumanoidJoystick, State
from nnx_ppo_tpu_torch.networks import (
    Concat,
    Dense,
    NormalTanhSampler,
    Parallel,
    PPOAdapter,
    Sequential,
    make_mlp,
)
from nnx_ppo_tpu_torch.ops.gae import gae_cuda
from nnx_ppo_tpu_torch.physics.cuda_step import ControlStepPlan, control_step_cuda, pack_params
from nnx_ppo_tpu_torch.physics.models import make_humanoid
from nnx_ppo_tpu_torch.physics.models.humanoid import DEFAULT_JOINT_POSE, default_qpos
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

B, N_STEPS = 2, 2
MODEL_KW = {
    "bare": {},
    "self_collision": dict(self_collision=True),
    "joint_limits": dict(joint_limits=True),
    "full": dict(self_collision=True, joint_limits=True),
}


@pytest.mark.parametrize("variant", list(MODEL_KW))
def test_humanoid_model_fields_match_jax(variant):
    """The model is numpy on both sides: equal to the bit."""
    want = jax_make_humanoid(**MODEL_KW[variant])
    got = make_humanoid(**MODEL_KW[variant])
    assert (got.n_bodies, got.nq, got.nv, got.nj) == (11, 17, 16, 10)
    assert len(got.geom_body) == 6
    assert len(got.pair_geom_a) == (4 if MODEL_KW[variant].get("self_collision") else 0)
    for name in (
        "parent", "joint_type", "geom_body", "pair_geom_a", "pair_geom_b", "gravity",
        "contact_stiffness", "contact_damping", "friction", "friction_vel",
        "max_contact_force", "limit_stiffness", "limit_damping",
    ):
        assert getattr(got, name) == getattr(want, name), name
    for name in (
        "joint_axis", "joint_pos", "mass", "com", "inertia", "geom_offset", "geom_radius",
        "damping", "armature", "joint_lower", "joint_upper", "spring_stiffness", "spring_ref",
    ):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.dof_slices() == want.dof_slices()
    np.testing.assert_array_equal(default_qpos(got), np.asarray(jax_default_qpos(want)))


@pytest.mark.parametrize("variant", ["bare", "full"])
def test_humanoid_control_step_plan_sizes(variant):
    """The kernel's -D sizes and the packed struct at the humanoid's own
    sizes: 11 bodies, 6 ground geoms, 0 or 4 pairs, 16 lanes per env, so
    that ``nv = 16`` puts one row per lane in the forward solve."""
    model = make_humanoid(**MODEL_KW[variant])
    full = variant == "full"
    plan = ControlStepPlan(model, 350.0, 0.002, 10, exact=full)
    assert plan.sizes == {"CS_NB": 11, "CS_NG": 6, "CS_NP": 4 if full else 0, "CS_NW": 0,
                          "CS_G": 16}
    assert plan.n_geoms == (10 if full else 6) and plan.n_extra == 0
    p = pack_params(plan)
    assert p.n_levels == 5 and list(p.level_start)[:6] == [0, 1, 5, 7, 9, 11]
    assert p.exact == int(full)
    assert list(p.child_list)[:4] == [10, 9, 5, 1]  # the trunk's arms and legs, last first
    lower = np.asarray(list(p.lower), np.float32)
    assert np.isfinite(lower).all() == full and np.isinf(lower).all() != full


def test_humanoid_env_defaults_match_jax():
    want = JaxHumanoidJoystick(substep_impl="xla")
    got = HumanoidJoystick()
    assert got.kp == want.kp == 350.0
    assert want.action_scale == 0.4
    np.testing.assert_array_equal(got.action_scale.numpy(), np.float32(want.action_scale))
    np.testing.assert_array_equal(got.max_command.numpy(), np.asarray(want.max_command))
    np.testing.assert_array_equal(got.default_pose.numpy(), np.asarray(want.default_pose))
    for name in ("stand_height", "min_up", "min_height", "reset_joint_noise", "n_feet",
                 "n_substeps", "control_dt", "reuse_mass_matrix"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.observation_size == want.observation_size == {"proprio": 36, "command": 3}
    assert got.action_size == want.action_size == 10
    np.testing.assert_array_equal(DEFAULT_JOINT_POSE.astype(np.float32), np.asarray(want.default_pose))
    assert got._control_runner.exact and got._control_runner.sizes["CS_NB"] == 11


def jax_lane_runner(model, kp, dt, n_substeps, exact):
    """``run_one`` of the JAX control-step runner (no per-env lanes, flat
    ground): the lane functions on one env's scalars."""

    def run(qpos, qvel, target):
        qp = tuple(qpos[k] for k in range(model.nq))
        qv = tuple(qvel[k] for k in range(model.nv))
        tgt = tuple(target[k] for k in range(model.nj))
        chol = None if exact else jax_crba_chol_soa(model, qp, dt)
        normals = None
        for _ in range(n_substeps):
            if exact:
                chol = jax_crba_chol_soa(model, qp, dt)
            qp, qv, normals = jax_substep_soa(model, qp, qv, tgt, chol, kp, dt, terrain=None)
        return jnp.stack(qp), jnp.stack(qv), jnp.stack(normals)

    return run


# mode -> env keyword arguments: the humanoid leg's held factor, and the
# full leg's exact factor with self-collision and joint limits.
MODES = {
    "held": dict(reuse_mass_matrix=True),
    "exact_full": dict(reuse_mass_matrix=False, self_collision=True, joint_limits=True),
}
COMMON_KW = dict(n_substeps=2, command_resample_prob=0.5)


def stack_np(items):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *items)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module", params=list(MODES))
def jax_trajectory(request):
    """JAX reset and N_STEPS steps of B envs, with every draw, as numpy."""
    kw = dict(MODES[request.param], **COMMON_KW)
    env = JaxHumanoidJoystick(substep_impl="pallas", **kw)
    env._control_runner = jax_lane_runner(
        env.model, env.kp, env.physics_dt, env.n_substeps, not env.reuse_mass_matrix
    )
    keys = [jax.random.key(s) for s in (0, 5)]
    # Actions around the default pose, some beyond the [-1, 1] clip.
    actions = np.random.RandomState(2).uniform(-1.2, 1.2, (N_STEPS, B, 10)).astype(np.float32)
    states = [env.reset(k) for k in keys]
    reset_draws = []
    for k in keys:
        k_pose, k_vel, k_cmd, _, _, _, _ = jax.random.split(k, 7)
        reset_draws.append({
            "joint_noise": jax.random.normal(k_pose, (10,)),
            "qvel_noise": jax.random.normal(k_vel, (16,)),
            "command": jax.random.uniform(k_cmd, (3,), minval=-1.0, maxval=1.0),
        })

    def strip(state):
        data = {k: v for k, v in state.data.items() if k != "key"}
        return dict(data=data, obs=state.obs, reward=state.reward, done=state.done,
                    metrics=state.metrics)

    out = dict(mode=request.param, kw=kw, actions=actions, reset=stack_np([strip(s) for s in states]),
               reset_draws=stack_np(reset_draws), steps=[], step_draws=[])
    for n in range(N_STEPS):
        draws = []
        for s in states:
            resample_key, cmd_key, _, _ = jax.random.split(s.data["key"], 4)
            draws.append({
                "resample": jax.random.bernoulli(resample_key, 0.5),
                "command": jax.random.uniform(cmd_key, (3,), minval=-1.0, maxval=1.0),
            })
        states = [env.step(s, jnp.asarray(a)) for s, a in zip(states, actions[n])]
        out["steps"].append(stack_np([strip(s) for s in states]))
        out["step_draws"].append(stack_np(draws))
    return out


def assert_state_close(state, want, atol_obs, atol_reward):
    for key in ("proprio", "command"):
        np.testing.assert_allclose(
            state.obs[key].numpy(), want["obs"][key], rtol=0, atol=atol_obs, err_msg=key
        )
    for key in ("tracking", "penalty"):
        np.testing.assert_allclose(
            state.reward[key].numpy(), want["reward"][key], rtol=0, atol=atol_reward, err_msg=key
        )
    np.testing.assert_array_equal(state.done.numpy(), want["done"])
    assert state.done.dtype == torch.float32


def test_reset_and_steps_match_jax_with_injected_draws(jax_trajectory):
    env = HumanoidJoystick(**jax_trajectory["kw"])
    want = jax_trajectory["reset"]
    state = env._reset_from(dict(
        {k: t(v) for k, v in jax_trajectory["reset_draws"].items()}, obs_noise=None
    ))
    for key in ("qpos", "qvel", "cmd", "prev_action"):
        np.testing.assert_allclose(
            state.data[key].numpy(), want["data"][key], rtol=0, atol=1e-6, err_msg=key
        )
    assert_state_close(state, want, atol_obs=1e-6, atol_reward=1e-6)
    for key in ("trunk_height", "speed", "foot_contacts", "contact_force"):
        np.testing.assert_allclose(state.metrics[key].numpy(), want["metrics"][key], rtol=0,
                                   atol=1e-6)

    resampled = contact = 0
    for n, (want, draws) in enumerate(zip(jax_trajectory["steps"], jax_trajectory["step_draws"])):
        before = control_step_cuda.launches
        state = env._step_from(
            state, t(jax_trajectory["actions"][n]), None,
            (t(draws["resample"]), t(draws["command"])), None,
        )
        assert control_step_cuda.launches == before  # CPU: the plain version
        np.testing.assert_allclose(state.data["qpos"].numpy(), want["data"]["qpos"], rtol=0,
                                   atol=2e-4)
        np.testing.assert_allclose(state.data["qvel"].numpy(), want["data"]["qvel"], rtol=0,
                                   atol=2e-3)
        np.testing.assert_allclose(state.data["cmd"].numpy(), want["data"]["cmd"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            state.data["prev_action"].numpy(), np.clip(jax_trajectory["actions"][n], -1, 1)
        )
        assert_state_close(state, want, atol_obs=2e-3, atol_reward=1e-4)
        for key in ("trunk_height", "speed"):
            np.testing.assert_allclose(state.metrics[key].numpy(), want["metrics"][key], rtol=0,
                                       atol=2e-3)
        np.testing.assert_array_equal(state.metrics["foot_contacts"].numpy(),
                                      want["metrics"]["foot_contacts"])
        np.testing.assert_allclose(state.metrics["contact_force"].numpy(),
                                   want["metrics"]["contact_force"], rtol=5e-3, atol=5e-2)
        resampled += int(draws["resample"].sum())
        contact += int((want["metrics"]["contact_force"] > 0).sum())
    # The draws resample some commands and keep others; feet touch.
    assert 0 < resampled < N_STEPS * B and contact > 0


def humanoid_net(seed=0, widths=(16, 8, 16)):
    """The humanoid legs' actor-critic (the physics leg's) at narrow widths."""
    enc_p, enc_c, hidden = widths
    g = torch.Generator().manual_seed(seed)
    enc = Concat.create(
        proprio=Dense.create(36, enc_p, g, torch.relu),
        command=Dense.create(3, enc_c, g, torch.relu),
    )
    actor = Sequential.create([
        Dense.create(enc_p + enc_c, hidden, g, torch.relu),
        Dense.create(hidden, 20, g),
        NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    critic = Parallel.create(
        tracking=make_mlp([enc_p + enc_c, hidden, 1], g, activation_last_layer=False),
        penalty=make_mlp([enc_p + enc_c, hidden, 1], g, activation_last_layer=False),
    )
    return Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])


@pytest.mark.parametrize("mode", list(MODES))
def test_humanoid_leg_ppo_step_on_the_cpu(mode):
    """The humanoid legs as a whole at a small size: 8 envs, dict obs,
    dict rewards, combined advantages; finite losses, parameters moved,
    no kernel launched on CPU tensors."""
    env = EpisodeWrapper(HumanoidJoystick(n_substeps=2, **MODES[mode]), max_len=500)
    config = PPOConfig(n_envs=8, rollout_length=3, n_epochs=2, n_minibatches=2,
                       combine_advantages=True)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(env, humanoid_net(), 8, seed=0, optimizer=optimizer, device="cpu")
    before_params = [p.detach().clone() for p in ts.networks.parameters()]
    launches = (control_step_cuda.launches, gae_cuda.launches)
    ts, metrics = ppo_step(env, ts, config, optimizer)
    assert (control_step_cuda.launches, gae_cuda.launches) == launches
    assert ts.steps_taken == 24
    for key in ("losses/actor/mean", "losses/critic/tracking/mean", "losses/critic/penalty/mean"):
        assert torch.isfinite(metrics[key]), key
    assert any(not torch.equal(a, b) for a, b in zip(before_params, ts.networks.parameters()))
    assert ts.env_states.obs["proprio"].shape == (8, 36)
    assert isinstance(ts.env_states, State) and set(ts.env_states.reward) == {"tracking", "penalty"}
