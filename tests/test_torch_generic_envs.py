"""The envs on the generic engine (``substep_impl="xla"``) against the
JAX package, and what ``substep_impl`` picks.

JAX's ``QuadrupedJoystick(depthwise=False, substep_impl="xla")`` with
domain randomization, pushes and rough terrain, and its ``ArmReacher`` /
``ArmPush`` with ``substep_impl="xla"``, vmapped and jitted, against the
port's envs with ``substep_impl="xla"`` on CPU tensors, with the JAX draws
injected (the key splits of nnx_ppo_tpu/envs/legged.py:665-700, 712-723,
816-822; reacher.py:186-198; pusher.py:234-252), as in
test_torch_legged.py and test_torch_manip.py.

Tolerances: reset is elementwise float32, 1e-6. Env steps on the generic
engine on both sides (two substeps; for the manipulation envs two env
steps): qpos 2e-5, qvel 5e-4, obs 5e-4, rewards 1e-4, contact force rtol
1e-4 / atol 1e-3, as test_torch_manip.py holds the same JAX steps to the
scene runner. The port's generic engine against its own plain control
step (another algorithm: 6x6 spatial algebra against the scalar lane
forms): qpos 2e-6, qvel 1e-4 over one control step, the gap measured
1.2e-7 and 1.7e-5 on four substeps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.envs import ArmPush as JaxArmPush
from nnx_ppo_tpu.envs import ArmReacher as JaxArmReacher
from nnx_ppo_tpu.envs import QuadrupedJoystick as JaxQuadrupedJoystick
from nnx_ppo_tpu.physics.randomize import DomainRandomization as JaxDomainRandomization
from nnx_ppo_tpu.physics.terrain import rough_terrain as jax_rough_terrain
from nnx_ppo_tpu_torch.convert import legged_state_data
from nnx_ppo_tpu_torch.envs import ArmPush, ArmReacher, LeggedJoystick, QuadrupedJoystick, State
from nnx_ppo_tpu_torch.physics import DomainParams, DomainRandomization
from nnx_ppo_tpu_torch.physics.cuda_scene_step import scene_step_cuda
from nnx_ppo_tpu_torch.physics.cuda_step import control_step_cuda
from nnx_ppo_tpu_torch.physics.models import make_quadruped
from nnx_ppo_tpu_torch.physics.terrain import rough_terrain

torch.set_num_threads(1)

B = 4
N_SUBSTEPS = 2
ROUGH = dict(seed=2, amplitude=0.03, wavelength=1.5)
DR_RANGES = dict(
    mass_scale=(0.8, 1.2), friction=(0.4, 1.0), damping_scale=(0.9, 1.1), gain_scale=(0.9, 1.1)
)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def stack_np(items):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *items)


def jax_legged_draws(env, key):
    """The reset draws and the first step's draws of LeggedJoystick for one
    env (nnx_ppo_tpu/envs/legged.py:665-700, 712-723, 816-822)."""
    k_pose, k_vel, k_cmd, k_carry, k_xy, k_dr, _ = jax.random.split(key, 7)
    dr = env.randomize.sample(k_dr)
    k_push, k_dir, key_rest = jax.random.split(k_carry, 3)
    resample_key, cmd_key, _, _ = jax.random.split(key_rest, 4)
    return {
        "reset": {
            "joint_noise": jax.random.normal(k_pose, (env.n_act,)),
            "qvel_noise": jax.random.normal(k_vel, (env.model.nv,)),
            "command": jax.random.uniform(k_cmd, (3,), minval=-1.0, maxval=1.0),
            "spawn": jax.random.uniform(k_xy, (2,), minval=-1.0, maxval=1.0),
            "dr": {name: getattr(dr, name) for name in DR_RANGES},
            "obs_noise": None,
        },
        "pushing": jax.random.bernoulli(k_push, env.push_prob),
        "theta": jax.random.uniform(k_dir, (), minval=0.0, maxval=2.0 * jnp.pi),
        "resample": jax.random.bernoulli(resample_key, env.command_resample_prob),
        "command": jax.random.uniform(cmd_key, (3,), minval=-1.0, maxval=1.0),
    }


LEGGED_KW = dict(push_prob=0.5, push_force=50.0, n_substeps=N_SUBSTEPS, command_resample_prob=0.5)


@pytest.fixture(scope="module")
def legged_xla():
    """JAX's QuadrupedJoystick(depthwise=False, substep_impl="xla") with DR,
    pushes, rough terrain and the held factor (the chip's generic path;
    the exact factor's forward_dynamics is in test_torch_generic_engine.py):
    reset and one step of B envs, jitted."""
    env = JaxQuadrupedJoystick(
        randomize=JaxDomainRandomization(**DR_RANGES), terrain=jax_rough_terrain(**ROUGH),
        reuse_mass_matrix=True, depthwise=False, substep_impl="xla", **LEGGED_KW,
    )
    # Seed 0: two of the four envs are pushed, two resample their command.
    keys = jax.random.split(jax.random.key(0), B)
    actions = np.random.RandomState(5).uniform(-1.2, 1.2, (B, 12)).astype(np.float32)
    reset = jax.vmap(env.reset)(keys)
    stepped = jax.jit(jax.vmap(env.step))(reset, jnp.asarray(actions))
    draws = stack_np([jax_legged_draws(env, k) for k in keys])
    port = QuadrupedJoystick(
        randomize=DomainRandomization(**DR_RANGES), terrain=rough_terrain(**ROUGH),
        reuse_mass_matrix=True, substep_impl="xla", **LEGGED_KW,
    )
    as_np = lambda s: jax.tree.map(np.asarray, dict(
        data={k: v for k, v in s.data.items() if k != "key"}, obs=s.obs, reward=s.reward,
        done=s.done, metrics=s.metrics))
    return port, actions, draws, as_np(reset), as_np(stepped)


def test_legged_xla_step_matches_jax(legged_xla):
    port, actions, draws, reset, want = legged_xla
    assert port._control_runner is None and port._substep_runner is None
    assert draws["pushing"].any() and not draws["pushing"].all()
    assert draws["resample"].any() and not draws["resample"].all()
    state0 = State(data=legged_state_data(reset["data"]), obs=None, reward=None,
                   done=torch.zeros(B), info={}, metrics={})
    before = control_step_cuda.launches
    state = port._step_from(
        state0, t(actions), (t(draws["pushing"]), t(draws["theta"])),
        (t(draws["resample"]), t(draws["command"])), None,
    )
    assert control_step_cuda.launches == before
    np.testing.assert_allclose(state.data["qpos"].numpy(), want["data"]["qpos"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(state.data["qvel"].numpy(), want["data"]["qvel"], rtol=0, atol=5e-4)
    for key in want["obs"]:
        np.testing.assert_allclose(state.obs[key].numpy(), want["obs"][key], rtol=0, atol=5e-4,
                                   err_msg=key)
    for key in want["reward"]:
        np.testing.assert_allclose(state.reward[key].numpy(), want["reward"][key], rtol=0,
                                   atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(state.done.numpy(), want["done"])
    np.testing.assert_allclose(state.metrics["contact_force"].numpy(),
                               want["metrics"]["contact_force"], rtol=1e-4, atol=1e-3)
    assert (want["metrics"]["contact_force"] > 0).any()


def test_legged_reset_on_the_generic_engine_matches_jax(legged_xla):
    port, _, draws, reset, _ = legged_xla
    d = dict(draws["reset"])
    d["dr"] = DomainParams(**{k: t(v) for k, v in d["dr"].items()})
    state = port._reset_from({k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()})
    for key in ("qpos", "qvel", "cmd"):
        np.testing.assert_allclose(state.data[key].numpy(), reset["data"][key], rtol=0, atol=1e-6)


def test_legged_generic_engine_matches_the_plain_control_step(legged_xla):
    """The port's generic engine against its own plain control step (the
    kernel's plain version) on the same env, state, action and draws."""
    port, actions, draws, reset, _ = legged_xla
    runner_env = QuadrupedJoystick(
        randomize=DomainRandomization(**DR_RANGES), terrain=rough_terrain(**ROUGH),
        reuse_mass_matrix=port.reuse_mass_matrix, **LEGGED_KW,
    )
    assert runner_env._control_runner is not None
    state0 = State(data=legged_state_data(reset["data"]), obs=None, reward=None,
                   done=torch.zeros(B), info={}, metrics={})
    args = (t(actions), (t(draws["pushing"]), t(draws["theta"])),
            (t(draws["resample"]), t(draws["command"])), None)
    a = port._step_from(state0, *args)
    b = runner_env._step_from(state0, *args)
    torch.testing.assert_close(a.data["qpos"], b.data["qpos"], rtol=0, atol=2e-6)
    torch.testing.assert_close(a.data["qvel"], b.data["qvel"], rtol=0, atol=1e-4)


def reacher_draws(key):
    k_q, k_v, k_t = jax.random.split(key, 3)
    k_dir, k_rad = jax.random.split(k_t)
    return {"tilt": jax.random.normal(k_q, (3,)), "qvel_noise": jax.random.normal(k_v, (4,)),
            "target_dir": jax.random.normal(k_dir, (3,)),
            "target_radius": jax.random.uniform(k_rad, (), minval=0.25, maxval=0.6)}


def pusher_draws(key):
    k_q, k_b, k_t = jax.random.split(key, 3)
    k_ba, k_br = jax.random.split(k_b)
    k_ta, k_tr = jax.random.split(k_t)
    two_pi = 2.0 * jnp.pi
    return {"tilt": jax.random.normal(k_q, (3,)),
            "ball_angle": jax.random.uniform(k_ba, (), minval=0.0, maxval=two_pi),
            "ball_radius": jax.random.uniform(k_br, (), minval=0.15, maxval=0.3),
            "target_angle": jax.random.uniform(k_ta, (), minval=0.0, maxval=two_pi),
            "target_radius": jax.random.uniform(k_tr, (), minval=0.25, maxval=0.45)}


MANIPULATION = {
    "reacher": (JaxArmReacher, ArmReacher, reacher_draws),
    "pusher": (JaxArmPush, ArmPush, pusher_draws),
}


@pytest.mark.parametrize("name", list(MANIPULATION))
def test_manipulation_xla_steps_match_jax(name):
    """Two env steps of two substeps on the generic engine on both sides
    (``engine.step`` for the reacher, ``scene_step`` for the pusher)."""
    jax_cls, port_cls, draw = MANIPULATION[name]
    env = jax_cls(n_substeps=N_SUBSTEPS, substep_impl="xla")
    keys = jax.random.split(jax.random.key(8), B)
    actions = np.random.RandomState(8).uniform(-1.3, 1.3, (2, B, 4)).astype(np.float32)
    state = jax.vmap(env.reset)(keys)
    jax_step = jax.jit(jax.vmap(env.step))
    port = port_cls(n_substeps=N_SUBSTEPS, substep_impl="xla")
    assert port._scene_runner is None
    got = port._reset_from({k: t(v) for k, v in stack_np([draw(k) for k in keys]).items()})
    before = scene_step_cuda.launches
    for action in actions:
        state = jax_step(state, jnp.asarray(action))
        got = port.step(got, t(action))
        for key, value in state.data.items():
            atol = 5e-4 if "qvel" in key else 2e-5
            np.testing.assert_allclose(got.data[key].numpy(), np.asarray(value), rtol=0,
                                       atol=atol, err_msg=key)
        np.testing.assert_allclose(got.obs.numpy(), np.asarray(state.obs), rtol=0, atol=5e-4)
        np.testing.assert_allclose(got.reward.numpy(), np.asarray(state.reward), rtol=0,
                                   atol=1e-4)
    assert scene_step_cuda.launches == before


# -- substep_impl: JAX's values and what they pick -----------------------------------


def test_substep_impl_values_pick_the_dynamics_path():
    """"auto" takes a runner where the model and features are supported and
    the generic engine otherwise; "pallas" takes a runner or raises JAX's
    ValueError; "xla" always takes the generic engine; anything else is
    refused as in JAX (nnx_ppo_tpu/envs/legged.py:309-316)."""
    assert QuadrupedJoystick()._control_runner is not None
    assert QuadrupedJoystick(substep_impl="pallas")._control_runner is not None
    xla = QuadrupedJoystick(substep_impl="xla", depthwise=False)
    assert xla._control_runner is None and xla._substep_runner is None
    # The factor passed in needs the held factor and bare features: on
    # "auto" the env takes the generic engine instead.
    auto = QuadrupedJoystick(pallas_in_kernel_factor=False, terrain=rough_terrain(**ROUGH),
                             reuse_mass_matrix=True)
    assert auto._control_runner is None and auto._substep_runner is None
    # A fixed-base model has no SoA runner: "pallas" raises JAX's error,
    # "auto" takes the generic engine.
    fixed = dataclasses.replace(make_quadruped(), joint_type=("hinge",) * 13)
    with pytest.raises(ValueError, match="substep_impl='pallas' unsupported: .*free-base"):
        LeggedJoystick(fixed, np.zeros(12), 0.3, kp=60.0, action_scale=0.5, substep_impl="pallas")
    assert LeggedJoystick(fixed, np.zeros(12), 0.3, kp=60.0, action_scale=0.5)._control_runner is None
    for bad in ("triton", "XLA"):
        with pytest.raises(ValueError, match="substep_impl must be"):
            QuadrupedJoystick(substep_impl=bad)
    with pytest.raises(NotImplementedError, match="depthwise"):
        QuadrupedJoystick(substep_impl="xla", depthwise=True)


def test_a_model_the_runner_refuses_steps_on_the_generic_engine():
    """A free-base model with a slide joint (outside the SoA feature set:
    each knee slides) constructs on "auto" and steps, where the port raised
    before."""
    model = make_quadruped()
    joints = list(model.joint_type)
    for knee in (3, 6, 9, 12):
        joints[knee] = "slide"
    model = dataclasses.replace(model, joint_type=tuple(joints))
    env = LeggedJoystick(model, np.zeros(12), 0.35, kp=40.0, action_scale=0.1, n_substeps=2)
    assert env._control_runner is None and env._substep_runner is None
    state = env.reset(3, torch.Generator().manual_seed(0))
    nxt = env.step(state, torch.full((3, 12), 0.5), torch.Generator().manual_seed(1))
    assert torch.isfinite(nxt.data["qpos"]).all() and torch.isfinite(nxt.data["qvel"]).all()
    assert not torch.equal(nxt.data["qpos"], state.data["qpos"])


# -- the two new training paths at a small size --------------------------------------


def physics_net(seed=0, widths=(16, 8, 16)):
    """The physics leg's actor-critic at narrow widths (proprio 42: both
    quadrupeds have 12 joints)."""
    from nnx_ppo_tpu_torch.networks import (
        Concat, Dense, NormalTanhSampler, Parallel, PPOAdapter, Sequential, make_mlp,
    )

    enc_p, enc_c, hidden = widths
    g = torch.Generator().manual_seed(seed)
    enc = Concat.create(
        proprio=Dense.create(42, enc_p, g, torch.relu), command=Dense.create(3, enc_c, g, torch.relu),
    )
    actor = Sequential.create([
        Dense.create(enc_p + enc_c, hidden, g, torch.relu), Dense.create(hidden, 24, g),
        NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    critic = Parallel.create(
        tracking=make_mlp([enc_p + enc_c, hidden, 1], g, activation_last_layer=False),
        penalty=make_mlp([enc_p + enc_c, hidden, 1], g, activation_last_layer=False),
    )
    return Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])


@pytest.mark.parametrize("path", ["mjcf_quadruped", "quadruped_fastM_generic"])
def test_new_paths_ppo_step_on_the_cpu(path):
    """mjcf_quadruped (the saved import through legged_from_import, held
    factor: the control-step runner) and quadruped_2048_fastM_generic
    (substep_impl="xla", depthwise=False, held factor: the generic engine)
    at 8 envs: finite losses, parameters moved, no kernel launched on CPU
    tensors."""
    from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer, new_training_state, ppo_step
    from nnx_ppo_tpu_torch.ops.gae import gae_cuda
    from nnx_ppo_tpu_torch.physics.models.mjcf_quadruped import make_env
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    if path == "mjcf_quadruped":
        legged = make_env(reuse_mass_matrix=True, n_substeps=2)
        assert legged._control_runner is not None
    else:
        legged = QuadrupedJoystick(reuse_mass_matrix=True, depthwise=False, substep_impl="xla",
                                   n_substeps=2)
        assert legged._control_runner is None
    env = EpisodeWrapper(legged, max_len=500)
    config = PPOConfig(n_envs=8, rollout_length=3, n_epochs=2, n_minibatches=2,
                       combine_advantages=True)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(env, physics_net(), 8, seed=0, optimizer=optimizer, device="cpu")
    before = [p.detach().clone() for p in ts.networks.parameters()]
    launches = (control_step_cuda.launches, gae_cuda.launches)
    ts, metrics = ppo_step(env, ts, config, optimizer)
    assert (control_step_cuda.launches, gae_cuda.launches) == launches
    assert ts.steps_taken == 24
    for key in ("losses/actor/mean", "losses/critic/tracking/mean", "losses/critic/penalty/mean"):
        assert torch.isfinite(metrics[key]), key
    assert any(not torch.equal(a, b) for a, b in zip(before, ts.networks.parameters()))
