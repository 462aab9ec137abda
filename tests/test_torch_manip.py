"""ArmReacher / ArmPush parity and the manipulation slice as a whole.

The JAX envs split a per-env key in ``reset``; the port draws from one
generator behind ``_draw_reset``. The tests repeat the JAX key splits
(nnx_ppo_tpu/envs/reacher.py:90-96, 186-198; pusher.py:234-252), stack the
draws over envs and hand them to the port's ``_reset_from``. The JAX envs
step on the generic engine (``substep_impl="xla"``: ``engine.step``,
``scene.scene_step``), the port on the plain version of the scene control
step (CPU tensors).

Tolerances: reset is elementwise float32, 1e-6. Two env steps of two
substeps each against the generic engine (6x6 matrix algebra, another
order of operations): qpos 2e-5, qvel 5e-4 as in the JAX package's
``tests/test_soa_general.py``; obs 5e-4 (it holds qvel), reward and
distances 1e-4.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.algorithms.ppo import ppo_loss as jax_ppo_loss
from nnx_ppo_tpu.algorithms.types import LoggingLevel as JaxLoggingLevel
from nnx_ppo_tpu.algorithms.types import Transition as JaxTransition
from nnx_ppo_tpu.core.struct import partition_params
from nnx_ppo_tpu.envs import ArmReacher as JaxArmReacher
from nnx_ppo_tpu.envs.pusher import ArmPush as JaxArmPush
from nnx_ppo_tpu.networks import make_mlp_actor_critic as jax_make_mlp_actor_critic
from nnx_ppo_tpu_torch.algorithms import (
    LoggingLevel,
    PPOConfig,
    make_optimizer,
    new_training_state,
    ppo_loss,
    ppo_step,
)
from nnx_ppo_tpu_torch.convert import load_jax_leaves, to_torch
from nnx_ppo_tpu_torch.envs import ArmPush, ArmReacher, State
from nnx_ppo_tpu_torch.envs import pusher as pusher_module
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.ops.gae import gae_cuda
from nnx_ppo_tpu_torch.physics.cuda_scene_step import SceneStepPlan, scene_step_cuda
from nnx_ppo_tpu_torch.physics.cuda_step import control_step_cuda
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

B = 4
N_SUBSTEPS = 2


def stack_np(items):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *items)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def reacher_draws(env, key):
    """The draws of the JAX ArmReacher.reset for one env, from its key."""
    k_q, k_v, k_t = jax.random.split(key, 3)
    k_dir, k_rad = jax.random.split(k_t)
    lo, hi = env.target_radius
    return {
        "tilt": jax.random.normal(k_q, (3,)),
        "qvel_noise": jax.random.normal(k_v, (4,)),
        "target_dir": jax.random.normal(k_dir, (3,)),
        "target_radius": jax.random.uniform(k_rad, (), minval=lo, maxval=hi),
    }


def pusher_draws(env, key):
    """The draws of the JAX ArmPush.reset for one env, from its key."""
    k_q, k_b, k_t = jax.random.split(key, 3)
    k_ba, k_br = jax.random.split(k_b)
    k_ta, k_tr = jax.random.split(k_t)
    lo, hi = env.target_radius
    two_pi = 2.0 * jnp.pi
    return {
        "tilt": jax.random.normal(k_q, (3,)),
        "ball_angle": jax.random.uniform(k_ba, (), minval=0.0, maxval=two_pi),
        "ball_radius": jax.random.uniform(k_br, (), minval=0.15, maxval=0.3),
        "target_angle": jax.random.uniform(k_ta, (), minval=0.0, maxval=two_pi),
        "target_radius": jax.random.uniform(k_tr, (), minval=lo, maxval=hi),
    }


ENVS = {
    "reacher": (JaxArmReacher, ArmReacher, reacher_draws),
    "pusher": (JaxArmPush, ArmPush, pusher_draws),
}


def strip(state):
    return dict(data=state.data, obs=state.obs, reward=state.reward, done=state.done,
                metrics=state.metrics)


@pytest.fixture(scope="module", params=list(ENVS))
def trajectory(request):
    """JAX reset and two steps of B envs on the generic engine, with the
    reset draws, as numpy; and the port's env."""
    jax_cls, port_cls, draw = ENVS[request.param]
    env = jax_cls(n_substeps=N_SUBSTEPS, substep_impl="xla")
    keys = jax.random.split(jax.random.key(7), B)
    actions = np.random.RandomState(0).uniform(-1.3, 1.3, (2, B, 4)).astype(np.float32)
    reset = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    first = step(reset, jnp.asarray(actions[0]))
    second = step(first, jnp.asarray(actions[1]))
    return dict(
        name=request.param, port=port_cls(n_substeps=N_SUBSTEPS), actions=actions,
        draws=stack_np([draw(env, k) for k in keys]),
        reset=jax.tree.map(np.asarray, strip(reset)),
        steps=[jax.tree.map(np.asarray, strip(s)) for s in (first, second)],
    )


def assert_state_close(state, want, atol_q, atol_v, atol_obs, atol_reward):
    assert set(state.data) == set(want["data"])
    for key, value in want["data"].items():
        atol = atol_v if "qvel" in key else atol_q
        np.testing.assert_allclose(state.data[key].numpy(), value, rtol=0, atol=atol, err_msg=key)
    np.testing.assert_allclose(state.obs.numpy(), want["obs"], rtol=0, atol=atol_obs)
    np.testing.assert_allclose(state.reward.numpy(), want["reward"], rtol=0, atol=atol_reward)
    np.testing.assert_array_equal(state.done.numpy(), want["done"])
    assert state.done.dtype == torch.float32 and state.done.shape == (B,)
    assert set(state.metrics) == set(want["metrics"])
    for key, value in want["metrics"].items():
        np.testing.assert_allclose(state.metrics[key].numpy(), value, rtol=0, atol=atol_reward)


def test_reset_matches_jax_with_injected_draws(trajectory):
    env = trajectory["port"]
    state = env._reset_from({k: t(v) for k, v in trajectory["draws"].items()})
    assert_state_close(state, trajectory["reset"], 1e-6, 1e-6, 1e-6, 1e-6)
    width = {"reacher": 18, "pusher": 22}[trajectory["name"]]
    assert state.obs.shape == (B, width) and env.observation_size == width and env.action_size == 4


def test_two_steps_match_jax_on_the_generic_engine(trajectory):
    env = trajectory["port"]
    state = State(data=to_torch(trajectory["reset"]["data"]), obs=None, reward=None,
                  done=torch.zeros(B), info={}, metrics={})
    before = scene_step_cuda.launches
    for action, want in zip(trajectory["actions"], trajectory["steps"]):
        state = env.step(state, t(action))
        assert_state_close(state, want, 2e-5, 5e-4, 5e-4, 1e-4)
    assert scene_step_cuda.launches == before  # CPU tensors: the plain version
    moved = np.abs(trajectory["steps"][1]["obs"] - trajectory["reset"]["obs"]).max()
    assert moved > 1e-2  # the steps did something


def test_pusher_clamps_velocities_and_ends_when_the_ball_escapes():
    env = ArmPush(n_substeps=N_SUBSTEPS)
    state = env.reset(3, torch.Generator().manual_seed(0))
    assert not state.done.any()
    q = dict(state.data)
    q["ball_qpos"] = q["ball_qpos"].clone()
    q["ball_qpos"][0, 0] = 2.5  # beyond the 2 m workspace
    q["arm_qvel"] = torch.full((3, 4), 500.0)
    q["ball_qvel"] = torch.full((3, 6), -500.0)
    np.testing.assert_array_equal(env._state(q, torch.zeros(3, 4)).done.numpy(), [1.0, 0.0, 0.0])
    nxt = env.step(state.replace(data=q), torch.zeros(3, 4))
    assert nxt.data["arm_qvel"].abs().max() <= 30.0
    assert nxt.data["ball_qvel"][:, :3].abs().max() <= 150.0
    assert nxt.data["ball_qvel"][:, 3:].abs().max() <= 20.0
    assert (pusher_module.BALL_RADIUS, pusher_module.SHOULDER_HEIGHT) == (0.08, 0.55)


def test_draws_come_from_the_generator_in_a_fixed_order():
    for cls in (ArmReacher, ArmPush):
        env = cls(n_substeps=N_SUBSTEPS)
        a = env.reset(4, torch.Generator().manual_seed(3))
        b = env.reset(4, torch.Generator().manual_seed(3))
        c = env.reset(4, torch.Generator().manual_seed(4))
        torch.testing.assert_close(a.obs, b.obs, rtol=0, atol=0)
        assert not torch.equal(a.obs, c.obs)
        radius = torch.linalg.norm(a.data["target"], dim=-1)
        lo, hi = env.target_radius
        assert bool((radius >= lo - 1e-6).all() and (radius <= hi + 1e-6).all())
        # step draws nothing: a generator is accepted and ignored.
        s1 = env.step(a, torch.zeros(4, 4), torch.Generator().manual_seed(1))
        s2 = env.step(b, torch.zeros(4, 4))
        torch.testing.assert_close(s1.obs, s2.obs, rtol=0, atol=0)


def test_envs_step_through_the_scene_runner_only():
    """``substep_impl`` "auto" (the default) and "pallas" step through the
    scene runner, dispatched by the tensors' device; "xla" steps the
    generic engine (tests/test_torch_generic_engine.py)."""
    reacher, pusher = ArmReacher(), ArmPush()
    assert isinstance(reacher._scene_runner, SceneStepPlan)
    assert (reacher._scene_runner.n_substeps, reacher._scene_runner.dt) == (4, 0.005)
    assert len(reacher._scene_runner.models) == 1 and reacher._scene_runner.pairs == ()
    assert (pusher._scene_runner.n_substeps, pusher._scene_runner.dt) == (16, 0.00125)
    assert pusher._scene_runner.pairs == ((0, 0, 1, 0),) and pusher.scene.pairs == ((0, 0, 1, 0),)
    assert (pusher._scene_runner.nq, pusher._scene_runner.nv, pusher._scene_runner.n_normals) == (12, 10, 3)
    assert isinstance(ArmPush(substep_impl="pallas")._scene_runner, SceneStepPlan)
    assert ArmReacher(substep_impl="xla")._scene_runner is None
    with pytest.raises(ValueError, match="substep_impl"):
        ArmReacher(substep_impl="triton")
    with pytest.raises(ValueError, match="substep_impl"):
        ArmPush(substep_impl="warp")


# -- the slice as a whole ------------------------------------------------------------


@pytest.mark.parametrize("name", ["reacher", "pusher"])
def test_manipulation_ppo_step_on_the_cpu(name):
    """8 envs, two substeps, the suite's net at narrow widths: finite
    losses, parameters moved, no kernel launched on CPU tensors."""
    inner, max_len = (ArmReacher, 150) if name == "reacher" else (ArmPush, 200)
    env = EpisodeWrapper(inner(n_substeps=N_SUBSTEPS), max_len=max_len)
    net = make_mlp_actor_critic(
        env.observation_size, env.action_size, [16, 16], [32, 32], 0,
        entropy_weight=2e-3, normalize_obs=True,
    )
    config = PPOConfig(n_envs=8, rollout_length=3, n_epochs=2, n_minibatches=2)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(env, net, 8, seed=0, optimizer=optimizer, device="cpu")
    before_params = [p.detach().clone() for p in ts.networks.parameters()]
    counters = (scene_step_cuda, control_step_cuda, gae_cuda)
    launches = [c.launches for c in counters]
    ts, metrics = ppo_step(env, ts, config, optimizer)
    assert [c.launches for c in counters] == launches
    assert ts.steps_taken == 24
    for key in ("losses/actor/mean", "losses/critic/mean"):
        assert torch.isfinite(metrics[key]), key
    assert any(not torch.equal(a, b) for a, b in zip(before_params, ts.networks.parameters()))
    assert ts.env_states.obs.shape == (8, env.observation_size)
    assert torch.isfinite(ts.env_states.obs).all()


def test_pusher_loss_and_gradients_match_jax_with_converted_weights():
    """The pusher's net (obs 22, action 4, obs normalization, entropy
    weight 2e-3) at narrow widths on a rollout whose obs, rewards and
    flags come from numpy and whose actions come from the JAX net. rtol
    1e-4 / atol 1e-6: float32 sums over T B terms in another order."""
    T_, B_ = 6, 10
    jax_net = jax_make_mlp_actor_critic(
        22, 4, [16, 16], [32, 32], jax.random.key(1), entropy_weight=2e-3, normalize_obs=True
    )
    rng = np.random.RandomState(5)
    obs = rng.randn(T_ + 1, B_, 22).astype(np.float32)
    state = jax_net.initialize_state(B_)
    outs = []
    for step in range(T_):
        out = jax_net(state, jnp.asarray(obs[step]))
        state = out.next_state
        outs.append(out)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
    done = rng.rand(T_, B_) < 0.15
    rollout = JaxTransition(
        obs=jnp.asarray(obs[:-1]), network_output=stacked.output,
        rewards=jnp.asarray(rng.rand(T_, B_).astype(np.float32)),
        done=jnp.asarray(done), truncated=jnp.asarray(done & (rng.rand(T_, B_) < 0.5)),
        next_obs=jnp.asarray(obs[1:]), metrics={}, rollout_extras=stacked.rollout_extras,
    )
    kw = dict(clip_range=0.2, normalize_advantages=True, combine_advantages=False,
              discounting_factor=0.99, gae_lambda=0.95, critic_loss_weight=1.0)
    params, rest = partition_params(jax_net)
    scaled = jax.tree.map(lambda p: p * 1.05, params)

    def loss_fn(p):
        return jax_ppo_loss(p, rest, jax_net.initialize_state(B_), rollout,
                            logging_level=JaxLoggingLevel.LOSSES, fused_replay=True, **kw)

    (jax_loss, jax_metrics), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(scaled)

    from test_torch_ppo import np_leaves, port_transition

    net = make_mlp_actor_critic(22, 4, [16, 16], [32, 32], 0, entropy_weight=2e-3, normalize_obs=True)
    load_jax_leaves(net, np_leaves(params))
    load_jax_leaves(net, np_leaves(rest))
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(1.05)
    loss, metrics = ppo_loss(net, net.initialize_state(B_), port_transition(rollout),
                             logging_level=LoggingLevel.LOSSES, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_loss), rtol=1e-4, atol=1e-6)
    for key in ("losses/actor", "losses/critic", "losses/regularization"):
        np.testing.assert_allclose(
            metrics[key].item(), float(jax_metrics[key]), rtol=1e-4, atol=1e-6, err_msg=key
        )
    jax_grad_leaves = jax.tree.leaves(jax_grads)
    torch_grads = [p.grad.numpy() for p in net.parameters()]
    assert len(jax_grad_leaves) == len(torch_grads) == 12
    for g_jax, g_torch in zip(jax_grad_leaves, torch_grads):
        np.testing.assert_allclose(g_torch, np.asarray(g_jax), rtol=1e-4, atol=1e-6)


# -- imports and devices ----------------------------------------------------------------


def test_port_and_smoke_script_import_neither_jax_nor_the_jax_package():
    """Import every module of nnx_ppo_tpu_torch and chip_smoke.py in a
    fresh interpreter: no jax, flax, optax or nnx_ppo_tpu gets loaded,
    and the manipulation modules are among those imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nnx_ppo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'nnx_ppo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "banned = ('jax', 'jaxlib', 'flax', 'optax', 'nnx_ppo_tpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    for module in ("envs.reacher", "envs.pusher", "physics.scene", "physics.engine_soa_general",
                   "physics.cuda_scene_step", "physics.models.arm"):
        assert f"nnx_ppo_tpu_torch.{module}" in names


def test_entry_points_default_to_the_card(monkeypatch):
    """new_training_state with a manipulation env asks for ``cuda`` unless
    told otherwise, and says so where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = EpisodeWrapper(ArmPush(n_substeps=N_SUBSTEPS), max_len=200)
    net = make_mlp_actor_critic(22, 4, [16], [16], 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_training_state(env, net, 4, seed=0)
    ts = new_training_state(env, net, 4, seed=0, device="cpu")
    assert ts.env_states.obs.device.type == "cpu"
