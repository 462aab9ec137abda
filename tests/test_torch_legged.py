"""LeggedJoystick / QuadrupedJoystick parity: the port's batched env
against the JAX env stepped env by env, with the JAX draws injected.

The JAX env splits a per-env key; the port draws from one generator
behind ``_draw_*`` methods. The tests repeat the JAX key splits
(nnx_ppo_tpu/envs/legged.py:665-700, 712-723, 816-822), stack the draws
over envs and hand them to the port's ``_reset_from`` / ``_step_from``.
The JAX env runs its SoA path (``substep_impl="pallas"``, whose
unbatched call is the scalar-lane function, no kernel launch), eagerly.

The two further paths of the quadruped, data terrain (a HeightGrid
through the plane sampler) and the factor built outside the kernel
(``pallas_in_kernel_factor=False``), run bare: no randomization, pushes
or sensor noise, as the JAX package benchmarks them.

Tolerances: reset is elementwise float32, 1e-6. One env step is two
physics substeps: qpos 2e-4, qvel 2e-3 (see test_torch_physics.py), and
what is computed from them follows: obs 2e-3 (it holds qvel), rewards
1e-4, contact force rtol 5e-3 / atol 5e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.envs import QuadrupedJoystick as JaxQuadrupedJoystick
from nnx_ppo_tpu.physics import DomainRandomization as JaxDomainRandomization
from nnx_ppo_tpu.physics.terrain import HeightGrid as JaxHeightGrid
from nnx_ppo_tpu.physics.terrain import rough_terrain as jax_rough_terrain
from nnx_ppo_tpu_torch.algorithms import (
    PPOConfig,
    make_optimizer,
    new_training_state,
    ppo_step,
)
from nnx_ppo_tpu_torch.convert import heightgrid_from_fields, legged_state_data
from nnx_ppo_tpu_torch.envs import LeggedJoystick, QuadrupedJoystick, State, legged_from_mjcf
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
from nnx_ppo_tpu_torch.physics import DomainParams, DomainRandomization, HeightGrid
from nnx_ppo_tpu_torch.physics.cuda_step import (
    control_step_cuda,
    plane_sampler_cuda,
    substeps_cuda,
)
from nnx_ppo_tpu_torch.physics.terrain import rough_terrain
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

B = 2
DR_RANGES = dict(
    mass_scale=(0.8, 1.2), friction=(0.4, 1.0), damping_scale=(0.9, 1.1), gain_scale=(0.9, 1.1)
)
ENV_KW = dict(
    reuse_mass_matrix=True, push_prob=0.5, push_force=50.0, n_substeps=2,
    obs_noise=0.01, height_scan=3, privileged_obs=True, command_resample_prob=0.5,
)
ROUGH = dict(seed=2, amplitude=0.03, wavelength=1.5)


def jax_env():
    return JaxQuadrupedJoystick(
        randomize=JaxDomainRandomization(**DR_RANGES), terrain=jax_rough_terrain(**ROUGH),
        substep_impl="pallas", **ENV_KW,
    )


def port_env(**overrides):
    kw = dict(ENV_KW, randomize=DomainRandomization(**DR_RANGES), terrain=rough_terrain(**ROUGH))
    kw.update(overrides)
    return QuadrupedJoystick(**kw)


def stack_np(items):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *items)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def jax_reset_draws(env, key):
    """The draws of LeggedJoystick.reset for one env, from its key."""
    k_pose, k_vel, k_cmd, _, k_xy, k_dr, k_noise = jax.random.split(key, 7)
    kp, ks = jax.random.split(k_noise)
    dr = env.randomize.sample(k_dr)
    return {
        "joint_noise": jax.random.normal(k_pose, (env.n_act,)),
        "qvel_noise": jax.random.normal(k_vel, (env.model.nv,)),
        "command": jax.random.uniform(k_cmd, (3,), minval=-1.0, maxval=1.0),
        "spawn": jax.random.uniform(k_xy, (2,), minval=-1.0, maxval=1.0),
        "dr": {name: getattr(dr, name) for name in DR_RANGES},
        "obs_noise": {
            "proprio": jax.random.normal(kp, (3 * env.n_act + 6,)),
            "height_scan": jax.random.normal(ks, (env.height_scan**2,)),
        },
    }


def jax_step_draws(env, key):
    """The draws of LeggedJoystick.step / _finish_step for one env."""
    k_push, k_dir, key_rest = jax.random.split(key, 3)
    resample_key, cmd_key, noise_key, _ = jax.random.split(key_rest, 4)
    kp, ks = jax.random.split(noise_key)
    return {
        "pushing": jax.random.bernoulli(k_push, env.push_prob),
        "theta": jax.random.uniform(k_dir, (), minval=0.0, maxval=2.0 * jnp.pi),
        "resample": jax.random.bernoulli(resample_key, env.command_resample_prob),
        "command": jax.random.uniform(cmd_key, (3,), minval=-1.0, maxval=1.0),
        "obs_noise": {
            "proprio": jax.random.normal(kp, (3 * env.n_act + 6,)),
            "height_scan": jax.random.normal(ks, (env.height_scan**2,)),
        },
    }


@pytest.fixture(scope="module")
def jax_trajectory():
    """JAX reset and one step for B envs, with every draw, as numpy."""
    env = jax_env()
    # Seeds chosen so that one env is pushed and one resamples its command.
    keys = [jax.random.key(s) for s in (0, 3)][:B]
    actions = np.random.RandomState(0).uniform(-1.2, 1.2, (B, 12)).astype(np.float32)
    reset_states = [env.reset(k) for k in keys]
    reset_draws = [jax_reset_draws(env, k) for k in keys]
    step_draws = [jax_step_draws(env, s.data["key"]) for s in reset_states]
    step_states = [env.step(s, jnp.asarray(a)) for s, a in zip(reset_states, actions)]

    def strip(state):
        data = {k: v for k, v in state.data.items() if k != "key"}
        data["dr"] = {name: getattr(state.data["dr"], name) for name in DR_RANGES}
        return dict(data=data, obs=state.obs, reward=state.reward, done=state.done,
                    metrics=state.metrics)

    return dict(
        actions=actions,
        reset=stack_np([strip(s) for s in reset_states]),
        reset_draws=stack_np(reset_draws),
        step=stack_np([strip(s) for s in step_states]),
        step_draws=stack_np(step_draws),
    )


def port_reset(env, draws):
    draws = dict(draws)
    draws["dr"] = DomainParams(**{k: t(v) for k, v in draws["dr"].items()})
    draws["obs_noise"] = {k: t(v) for k, v in draws["obs_noise"].items()}
    return env._reset_from({k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in draws.items()})


def assert_state_close(state, want, atol_obs, atol_reward):
    for key in ("proprio", "command", "height_scan", "privileged"):
        np.testing.assert_allclose(
            state.obs[key].numpy(), want["obs"][key], rtol=0, atol=atol_obs, err_msg=key
        )
    for key in ("tracking", "penalty"):
        np.testing.assert_allclose(
            state.reward[key].numpy(), want["reward"][key], rtol=0, atol=atol_reward, err_msg=key
        )
    np.testing.assert_array_equal(state.done.numpy(), want["done"])
    assert state.done.dtype == torch.float32


def test_reset_matches_jax_with_injected_draws(jax_trajectory):
    env = port_env()
    state = port_reset(env, jax_trajectory["reset_draws"])
    want = jax_trajectory["reset"]
    for key in ("qpos", "qvel", "cmd", "prev_action"):
        np.testing.assert_allclose(
            state.data[key].numpy(), want["data"][key], rtol=0, atol=1e-6, err_msg=key
        )
    for name in DR_RANGES:
        np.testing.assert_array_equal(getattr(state.data["dr"], name).numpy(), want["data"]["dr"][name])
    assert_state_close(state, want, atol_obs=1e-6, atol_reward=1e-6)
    for key in ("trunk_height", "speed", "foot_contacts", "contact_force"):
        np.testing.assert_allclose(state.metrics[key].numpy(), want["metrics"][key], rtol=0, atol=1e-6)
    assert env.observation_size == {"proprio": 42, "command": 3, "height_scan": 9, "privileged": 4}
    assert env.action_size == 12


def test_step_matches_jax_with_injected_draws(jax_trajectory):
    env = port_env()
    want0, want, draws = (jax_trajectory[k] for k in ("reset", "step", "step_draws"))
    assert draws["pushing"].any() and draws["resample"].any()
    assert not draws["pushing"].all() and not draws["resample"].all()
    state0 = State(
        data=legged_state_data(want0["data"]), obs=None, reward=None,
        done=torch.zeros(B), info={}, metrics={},
    )
    before = control_step_cuda.launches
    state = env._step_from(
        state0, t(jax_trajectory["actions"]),
        (t(draws["pushing"]), t(draws["theta"])),
        (t(draws["resample"]), t(draws["command"])),
        {k: t(v) for k, v in draws["obs_noise"].items()},
    )
    assert control_step_cuda.launches == before  # CPU: the plain version
    np.testing.assert_allclose(state.data["qpos"].numpy(), want["data"]["qpos"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(state.data["qvel"].numpy(), want["data"]["qvel"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(state.data["cmd"].numpy(), want["data"]["cmd"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        state.data["prev_action"].numpy(), np.clip(jax_trajectory["actions"], -1, 1)
    )
    assert_state_close(state, want, atol_obs=2e-3, atol_reward=1e-4)
    for key in ("trunk_height", "speed"):
        np.testing.assert_allclose(state.metrics[key].numpy(), want["metrics"][key], rtol=0, atol=2e-3)
    np.testing.assert_array_equal(state.metrics["foot_contacts"].numpy(), want["metrics"]["foot_contacts"])
    np.testing.assert_allclose(
        state.metrics["contact_force"].numpy(), want["metrics"]["contact_force"], rtol=5e-3, atol=5e-2
    )
    assert (want["metrics"]["contact_force"] > 0).any()


def test_done_on_tilt_and_height():
    env = port_env(obs_noise=0.0, height_scan=0, privileged_obs=False)
    state = env.reset(3, torch.Generator().manual_seed(0))
    assert not state.done.any()
    q = dict(state.data)
    qpos = q["qpos"].clone()
    qpos[0, 3:7] = torch.tensor([0.5, 0.0, 0.866, 0.0])  # pitched 120 degrees
    qpos[1, 2] -= 0.25  # trunk 6 cm above the local ground
    q["qpos"] = qpos
    np.testing.assert_array_equal(env._done(q).numpy(), [1.0, 1.0, 0.0])


def test_draws_come_from_the_generator_in_a_fixed_order():
    env = port_env()
    a = env.reset(4, torch.Generator().manual_seed(3))
    b = env.reset(4, torch.Generator().manual_seed(3))
    c = env.reset(4, torch.Generator().manual_seed(4))
    torch.testing.assert_close(a.data["qpos"], b.data["qpos"])
    torch.testing.assert_close(a.data["dr"].friction, b.data["dr"].friction)
    assert not torch.equal(a.data["qpos"], c.data["qpos"])
    dr = a.data["dr"]
    for name, (lo, hi) in DR_RANGES.items():
        x = getattr(dr, name)
        assert x.shape == (4,) and bool((x >= lo).all() and (x <= hi).all())
    action = torch.zeros(4, 12)
    s1 = env.step(a, action, torch.Generator().manual_seed(7))
    s2 = env.step(b, action, torch.Generator().manual_seed(7))
    torch.testing.assert_close(s1.obs["proprio"], s2.obs["proprio"])
    with pytest.raises(ValueError, match="generator"):
        env.step(a, action)


def test_exact_mode_is_the_default_and_differs_from_held():
    held = QuadrupedJoystick(reuse_mass_matrix=True, n_substeps=3)
    exact = QuadrupedJoystick(n_substeps=3)
    assert exact._control_runner.exact and not held._control_runner.exact
    s = held.reset(2, torch.Generator().manual_seed(0))
    action = torch.full((2, 12), 0.8)
    a = held.step(s, action, torch.Generator().manual_seed(1))
    b = exact.step(s, action, torch.Generator().manual_seed(1))
    diff = (a.data["qvel"] - b.data["qvel"]).abs().max().item()
    assert 1e-6 < diff < 0.5


@pytest.mark.parametrize(
    "build, error, match",
    [
        # The importer is ported: an MJCF without a jointed body is
        # refused as in JAX (nnx_ppo_tpu/physics/mjcf.py:487).
        (lambda: legged_from_mjcf("<mujoco/>"), ValueError, "no jointed bodies"),
        (lambda: QuadrupedJoystick(depthwise=True), NotImplementedError, "depthwise"),
        # A terrain that is neither analytic nor a HeightGrid is refused by
        # the kernel path (on "auto" the env takes the generic engine, as
        # JAX's does).
        (lambda: QuadrupedJoystick(terrain=object(), substep_impl="pallas"), ValueError,
         "HeightGrid"),
    ],
    ids=["mjcf", "depthwise", "grid_terrain"],
)
def test_left_features_raise_not_implemented(build, error, match):
    with pytest.raises(error, match=match):
        build()


# -- the two further paths: data terrain, and the factor built outside -----------

BARE_KW = dict(reuse_mass_matrix=True, n_substeps=2, command_resample_prob=0.5)


def path_envs(path):
    """(JAX env on its kernel path, the port's env) of one path."""
    if path == "heightgrid":
        jg = JaxHeightGrid.sample(jax_rough_terrain(**ROUGH), extent=8.0, n=48)
        tg = heightgrid_from_fields(np.asarray(jg.data), jg.x0, jg.y0, jg.dx, jg.dy)
        return (
            JaxQuadrupedJoystick(terrain=jg, substep_impl="pallas", **BARE_KW),
            QuadrupedJoystick(terrain=tg, **BARE_KW),
        )
    kw = dict(BARE_KW, pallas_in_kernel_factor=False, pallas_substeps_per_kernel=-1)
    return JaxQuadrupedJoystick(substep_impl="pallas", **kw), QuadrupedJoystick(**kw)


@pytest.fixture(scope="module", params=["heightgrid", "passed_in_factor"])
def path_trajectory(request):
    """JAX reset and one step of B bare envs with their draws, and the
    port's env of the same path."""
    jax_env_, port = path_envs(request.param)
    keys = [jax.random.key(s) for s in (0, 3)]
    # Gentle actions and a start 1 cm below the reset pose, so that a
    # foot still presses on the ground in the step's second substep (a
    # leg swung hard lifts its foot within two substeps).
    actions = np.random.RandomState(1).uniform(-0.3, 0.3, (B, 12)).astype(np.float32)
    resets = [jax_env_.reset(k) for k in keys]
    lowered = [
        dataclasses.replace(s, data=dict(s.data, qpos=s.data["qpos"].at[2].add(-0.01))) for s in resets
    ]
    reset_draws, step_draws = [], []
    for k, s in zip(keys, resets):
        k_pose, k_vel, k_cmd, _, k_xy, _, _ = jax.random.split(k, 7)
        reset_draws.append({
            "joint_noise": jax.random.normal(k_pose, (12,)),
            "qvel_noise": jax.random.normal(k_vel, (18,)),
            "command": jax.random.uniform(k_cmd, (3,), minval=-1.0, maxval=1.0),
            "spawn": jax.random.uniform(k_xy, (2,), minval=-1.0, maxval=1.0),
        })
        resample_key, cmd_key, _, _ = jax.random.split(s.data["key"], 4)
        step_draws.append({
            "resample": jax.random.bernoulli(resample_key, 0.5),
            "command": jax.random.uniform(cmd_key, (3,), minval=-1.0, maxval=1.0),
        })
    steps = [jax_env_.step(s, jnp.asarray(a)) for s, a in zip(lowered, actions)]

    def strip(state):
        data = {k: v for k, v in state.data.items() if k != "key"}
        return dict(data=data, obs=state.obs, reward=state.reward, done=state.done,
                    metrics=state.metrics)

    return dict(
        path=request.param, port=port, actions=actions,
        reset=stack_np([strip(s) for s in resets]), reset_draws=stack_np(reset_draws),
        lowered=stack_np([strip(s) for s in lowered]),
        step=stack_np([strip(s) for s in steps]), step_draws=stack_np(step_draws),
    )


def test_path_reset_matches_jax_with_injected_draws(path_trajectory):
    """Spawn height, reward, done and metrics use the bilinear height on
    data terrain: 1e-6."""
    env, want = path_trajectory["port"], path_trajectory["reset"]
    draws = {k: t(v) for k, v in path_trajectory["reset_draws"].items()}
    state = env._reset_from(dict(draws, obs_noise=None))
    for key in ("qpos", "qvel", "cmd", "prev_action"):
        np.testing.assert_allclose(
            state.data[key].numpy(), want["data"][key], rtol=0, atol=1e-6, err_msg=key
        )
    for key in ("proprio", "command"):
        np.testing.assert_allclose(state.obs[key].numpy(), want["obs"][key], rtol=0, atol=1e-6)
    for key in ("tracking", "penalty"):
        np.testing.assert_allclose(state.reward[key].numpy(), want["reward"][key], rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        state.metrics["trunk_height"].numpy(), want["metrics"]["trunk_height"], rtol=0, atol=1e-6
    )
    on_terrain = path_trajectory["path"] == "heightgrid"
    assert bool((state.data["qpos"][:, :2] != 0).any()) == on_terrain


def test_path_step_matches_jax_with_injected_draws(path_trajectory):
    """One env step of two substeps against the JAX env on its kernel
    path (``substep_impl="pallas"``): frozen planes on data terrain, the
    outside factor otherwise. qpos 2e-4, qvel 2e-3, obs 2e-3, rewards
    1e-4, contact force rtol 5e-3 / atol 5e-2."""
    env = path_trajectory["port"]
    want0, want, draws = (path_trajectory[k] for k in ("lowered", "step", "step_draws"))
    assert draws["resample"].any() and not draws["resample"].all()
    state0 = State(
        data=legged_state_data(want0["data"]), obs=None, reward=None,
        done=torch.zeros(B), info={}, metrics={},
    )
    counters = (control_step_cuda, plane_sampler_cuda, substeps_cuda)
    before = [c.launches for c in counters]
    state = env._step_from(
        state0, t(path_trajectory["actions"]), None,
        (t(draws["resample"]), t(draws["command"])), None,
    )
    assert [c.launches for c in counters] == before  # CPU: the plain versions
    np.testing.assert_allclose(state.data["qpos"].numpy(), want["data"]["qpos"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(state.data["qvel"].numpy(), want["data"]["qvel"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(state.data["cmd"].numpy(), want["data"]["cmd"], rtol=0, atol=1e-6)
    for key in ("proprio", "command"):
        np.testing.assert_allclose(state.obs[key].numpy(), want["obs"][key], rtol=0, atol=2e-3)
    for key in ("tracking", "penalty"):
        np.testing.assert_allclose(state.reward[key].numpy(), want["reward"][key], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(state.done.numpy(), want["done"])
    np.testing.assert_array_equal(
        state.metrics["foot_contacts"].numpy(), want["metrics"]["foot_contacts"]
    )
    np.testing.assert_allclose(
        state.metrics["contact_force"].numpy(), want["metrics"]["contact_force"], rtol=5e-3, atol=5e-2
    )
    assert (want["metrics"]["contact_force"] > 0).any()


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(), "reuse_mass_matrix=True"),
        (dict(reuse_mass_matrix=True, terrain=rough_terrain(**ROUGH)), "flat z=0 ground"),
        (dict(reuse_mass_matrix=True, randomize=DomainRandomization()), "DR overrides"),
        (dict(reuse_mass_matrix=True, push_prob=0.1, push_force=50.0), "push forces"),
        (dict(reuse_mass_matrix=True, n_substeps=10, pallas_substeps_per_kernel=4), "multiple"),
    ],
    ids=["exact_factor", "terrain", "randomize", "push", "4_of_10_substeps"],
)
def test_passed_in_factor_path_keeps_the_jax_refusals(kwargs, match):
    """nnx_ppo_tpu/envs/legged.py:322-357 and pallas_step.py:657-663: JAX
    raises these under substep_impl="pallas" (on "auto" it takes the
    generic engine instead, as the port does)."""
    with pytest.raises(ValueError, match=match):
        QuadrupedJoystick(pallas_in_kernel_factor=False, substep_impl="pallas", **kwargs)


def test_passed_in_factor_path_uses_the_substep_runner_only():
    env = QuadrupedJoystick(
        reuse_mass_matrix=True, pallas_in_kernel_factor=False, n_substeps=10,
        pallas_substeps_per_kernel=5,
    )
    assert env._control_runner is None and env._substep_runner.substeps_per_kernel == 5
    held = QuadrupedJoystick(reuse_mass_matrix=True, n_substeps=10)
    assert held._substep_runner is None
    s = held.reset(3, torch.Generator().manual_seed(0))
    action = torch.full((3, 12), 0.5)
    a = env.step(s, action, torch.Generator().manual_seed(1))
    b = held.step(s, action, torch.Generator().manual_seed(1))
    # The two factors agree to rounding, so the steps do (see
    # test_torch_engine.py for the measured gap).
    torch.testing.assert_close(a.data["qpos"], b.data["qpos"], rtol=0, atol=2e-6)
    torch.testing.assert_close(a.data["qvel"], b.data["qvel"], rtol=0, atol=2e-4)


def test_legged_joystick_is_generic_over_the_model():
    from nnx_ppo_tpu_torch.physics.models.quadruped import (
        DEFAULT_JOINT_POSE, STAND_HEIGHT, make_quadruped,
    )

    env = LeggedJoystick(
        make_quadruped(self_collision=True, joint_limits=True), DEFAULT_JOINT_POSE,
        STAND_HEIGHT, kp=40.0, action_scale=np.full(12, 0.3), n_substeps=2,
        reuse_mass_matrix=True,
    )
    state = env.reset(3, torch.Generator().manual_seed(0))
    state = env.step(state, torch.ones(3, 12), torch.Generator().manual_seed(0))
    assert torch.isfinite(state.obs["proprio"]).all() and state.obs["proprio"].shape == (3, 42)


def physics_net(seed=0, widths=(16, 8, 16)):
    """The physics leg's actor-critic at narrow widths."""
    enc_p, enc_c, hidden = widths
    g = torch.Generator().manual_seed(seed)
    enc = Concat.create(
        proprio=Dense.create(42, enc_p, g, torch.relu),
        command=Dense.create(3, enc_c, g, torch.relu),
    )
    actor = Sequential.create([
        Dense.create(enc_p + enc_c, hidden, g, torch.relu),
        Dense.create(hidden, 24, g),
        NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    critic = Parallel.create(
        tracking=make_mlp([enc_p + enc_c, hidden, 1], g, activation_last_layer=False),
        penalty=make_mlp([enc_p + enc_c, hidden, 1], g, activation_last_layer=False),
    )
    return Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "contiguous"])
def test_physics_leg_ppo_step_on_the_cpu(shuffle):
    """The slice as a whole at a small size: dict obs, dict rewards,
    per-key GAE, combined advantages, both minibatch modes."""
    env = EpisodeWrapper(
        QuadrupedJoystick(
            reuse_mass_matrix=True, randomize=DomainRandomization(**DR_RANGES),
            push_prob=0.02, push_force=50.0, terrain=rough_terrain(**ROUGH), n_substeps=2,
        ),
        max_len=500,
    )
    config = PPOConfig(
        n_envs=8, rollout_length=3, n_epochs=2, n_minibatches=2, combine_advantages=True,
        shuffle_minibatches=shuffle,
    )
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(env, physics_net(), 8, seed=0, optimizer=optimizer, device="cpu")
    before_params = [p.detach().clone() for p in ts.networks.parameters()]
    launches = (control_step_cuda.launches, gae_cuda.launches)
    ts, metrics = ppo_step(env, ts, config, optimizer)
    assert (control_step_cuda.launches, gae_cuda.launches) == launches
    assert ts.steps_taken == 24
    for key in ("losses/actor/mean", "losses/critic/tracking/mean", "losses/critic/penalty/mean"):
        assert torch.isfinite(metrics[key]), key
    assert any(
        not torch.equal(a, b) for a, b in zip(before_params, ts.networks.parameters())
    )
    assert ts.env_states.obs["proprio"].shape == (8, 42)
    assert set(ts.env_states.reward) == {"tracking", "penalty"}


@pytest.mark.parametrize("path", ["heightgrid", "passed_in_factor"])
def test_further_paths_ppo_step_on_the_cpu(path):
    """Each further path as a whole at a small size: 8 envs, finite
    losses, parameters moved, no kernel launched on CPU tensors."""
    if path == "heightgrid":
        grid = HeightGrid.sample(rough_terrain(**ROUGH), extent=12.0, n=32)
        legged = QuadrupedJoystick(reuse_mass_matrix=True, terrain=grid, n_substeps=2)
    else:
        legged = QuadrupedJoystick(
            reuse_mass_matrix=True, pallas_in_kernel_factor=False, pallas_substeps_per_kernel=-1,
            n_substeps=2,
        )
    env = EpisodeWrapper(legged, max_len=500)
    config = PPOConfig(n_envs=8, rollout_length=3, n_epochs=2, n_minibatches=2, combine_advantages=True)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(env, physics_net(), 8, seed=0, optimizer=optimizer, device="cpu")
    before_params = [p.detach().clone() for p in ts.networks.parameters()]
    counters = (control_step_cuda, plane_sampler_cuda, substeps_cuda, gae_cuda)
    launches = [c.launches for c in counters]
    ts, metrics = ppo_step(env, ts, config, optimizer)
    assert [c.launches for c in counters] == launches
    assert ts.steps_taken == 24
    for key in ("losses/actor/mean", "losses/critic/tracking/mean", "losses/critic/penalty/mean"):
        assert torch.isfinite(metrics[key]), key
    assert any(not torch.equal(a, b) for a, b in zip(before_params, ts.networks.parameters()))
    assert torch.isfinite(ts.env_states.obs["proprio"]).all()


def test_identity_domain_params_match_the_unrandomized_step():
    from nnx_ppo_tpu_torch.physics.cuda_step import make_control_step_runner
    from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
    from nnx_ppo_tpu_torch.physics.randomize import privileged_vector
    from nnx_ppo_tpu_torch.physics.testing import standing_states

    model = make_quadruped()
    dr = DomainRandomization(**DR_RANGES)
    params = dr.identity(model, 4)
    extra = privileged_vector(params)
    assert extra.shape == (4, dr.dim) and dr.fields == tuple(DR_RANGES)
    np.testing.assert_allclose(extra.numpy(), [[1.0, 0.8, 1.0, 1.0]] * 4)
    s = standing_states(model, default_qpos(model), 4, seed=0)
    args = [torch.from_numpy(s[k]) for k in ("qpos", "qvel", "target")]
    plain = make_control_step_runner(model, 60.0, 0.002, 2)(*args)
    with_dr = make_control_step_runner(model, 60.0, 0.002, 2, dr_fields=dr.fields)(*args, extra)
    for a, b in zip(plain, with_dr):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    partial = DomainRandomization(mass_scale=None, damping_scale=None)
    assert partial.fields == ("friction", "gain_scale") and partial.dim == 2
    assert partial.sample(3, torch.Generator().manual_seed(0)).mass_scale is None
