"""The analytic envs: ``CartpoleSwingup``, ``Pendulum``,
``JoystickLocomotion`` and ``NLinkSwingup`` of the port against the JAX
package's, with the JAX draws injected, and one ``ppo_step`` of each on
the CPU.

The JAX envs step one env and are vmapped (jitted here); the port's step
all envs at once. The tests repeat each JAX env's key splits
(``nnx_ppo_tpu/envs/classic.py:147-165``, ``locomotion.py:87-155``,
``chain.py:138-146``), stack the draws over envs and hand them to the
port's ``_reset_from`` / ``_step_from``; each side then steps from its own
state with the same actions.

Tolerances: reset is elementwise float32, 1e-6. Steps chain float32 sin,
cos, exp and small sums whose last bits differ between XLA's CPU kernels
and PyTorch's (and, for the chain, a 3 x 3 Cholesky solve per substep):
1e-5 absolute on state, obs and reward over the five steps of each case
(measured gaps: at most a few 1e-6); ``done`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.envs import CartpoleSwingup as JaxCartpoleSwingup
from nnx_ppo_tpu.envs import JoystickLocomotion as JaxJoystickLocomotion
from nnx_ppo_tpu.envs import NLinkSwingup as JaxNLinkSwingup
from nnx_ppo_tpu.envs import Pendulum as JaxPendulum
from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer, new_training_state, ppo_step
from nnx_ppo_tpu_torch.envs import (
    CartpoleBalance,
    CartpoleSwingup,
    JoystickLocomotion,
    NLinkSwingup,
    Pendulum,
)
from nnx_ppo_tpu_torch.envs.locomotion import GAIT_MAP
from nnx_ppo_tpu_torch.networks import (
    Concat,
    Dense,
    NormalTanhSampler,
    Parallel,
    PPOAdapter,
    Sequential,
    make_mlp,
    make_mlp_actor_critic,
)
from nnx_ppo_tpu_torch.ops.gae import gae_cuda
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

B, N_STEPS = 4, 5
ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- the draws of each JAX env, per env key ----------------------------------------


def cartpole_reset_draws(env, key):
    return jax.random.normal(key, (4,))


def pendulum_reset_draws(env, key):
    k1, k2 = jax.random.split(key)
    theta = jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi)
    theta_dot = jax.random.uniform(k2, (), minval=-1.0, maxval=1.0)
    return jnp.stack([theta, theta_dot])


def locomotion_reset_draws(env, key):
    k_cmd, k_vel, _ = jax.random.split(key, 3)
    return {"command": env._sample_command(k_cmd), "vel_noise": jax.random.normal(k_vel, (3,))}


def locomotion_step_draws(env, state):
    _, k_p, k_cmd = jax.random.split(state.data["rng"], 3)
    return (jax.random.bernoulli(k_p, env.command_resample_prob), env._sample_command(k_cmd))


def chain_reset_draws(env, key):
    k1, k2 = jax.random.split(key)
    return {
        "theta_noise": jax.random.normal(k1, (env.n_links,)),
        "theta_dot_noise": jax.random.normal(k2, (env.n_links,)),
    }


# name -> (JAX env, port env, reset draws, step draws or None, action size)
CASES = {
    "cartpole_swingup": (JaxCartpoleSwingup, CartpoleSwingup, cartpole_reset_draws, None, 1),
    "pendulum": (JaxPendulum, Pendulum, pendulum_reset_draws, None, 1),
    "locomotion": (
        lambda: JaxJoystickLocomotion(command_resample_prob=0.5),
        lambda: JoystickLocomotion(command_resample_prob=0.5),
        locomotion_reset_draws, locomotion_step_draws, 8,
    ),
    "chain_3": (lambda: JaxNLinkSwingup(n_links=3), lambda: NLinkSwingup(n_links=3),
                chain_reset_draws, None, 3),
}


def assert_tree_close(got, want, atol, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree_close(got[k], want[k], atol, f"{what}/{k}")
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol, err_msg=what)


def assert_state_close(got, want, atol, what):
    data = {k: v for k, v in want.data.items() if k != "rng"}
    assert_tree_close(got.data, data, atol, f"{what} data")
    assert_tree_close(got.obs, want.obs, atol, f"{what} obs")
    assert_tree_close(got.reward, want.reward, atol, f"{what} reward")
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done), err_msg=f"{what} done")
    assert got.done.dtype == torch.float32
    assert_tree_close(got.metrics, want.metrics, atol, f"{what} metrics")


@pytest.mark.parametrize("case", list(CASES))
def test_reset_and_steps_match_jax_with_injected_draws(case):
    make_jax, make_port, reset_draws, step_draws, n_act = CASES[case]
    jax_env, env = make_jax(), make_port()
    keys = jax.random.split(jax.random.key(3), B)
    actions = np.random.RandomState(1).uniform(-1.3, 1.3, (N_STEPS, B, n_act)).astype(np.float32)

    want = jax.jit(jax.vmap(jax_env.reset))(keys)
    draws = np_tree(jax.vmap(lambda k: reset_draws(jax_env, k))(keys))
    state = env._reset_from(jax.tree.map(t, draws))
    assert_state_close(state, want, 1e-6, "reset")

    jax_step = jax.jit(jax.vmap(jax_env.step))
    resampled = 0
    for n in range(N_STEPS):
        if step_draws is not None:
            resample, command = np_tree(jax.vmap(lambda s: step_draws(jax_env, s))(want))
            state = env._step_from(state, t(actions[n]), (t(resample), t(command)))
            resampled += int(resample.sum())
        else:
            state = env.step(state, t(actions[n]))
        want = jax_step(want, jnp.asarray(actions[n]))
        assert_state_close(state, want, ATOL, f"step {n}")
    if step_draws is not None:
        assert 0 < resampled < N_STEPS * B  # some commands resampled, some kept
    assert env.observation_size == jax_env.observation_size
    assert env.action_size == jax_env.action_size


def test_locomotion_gait_map_is_the_jax_envs():
    np.testing.assert_array_equal(GAIT_MAP, np.asarray(JaxJoystickLocomotion()._gait_map))


def test_the_swingup_starts_down_and_only_the_balance_task_ends_on_the_angle():
    g = torch.Generator().manual_seed(0)
    down = CartpoleSwingup().reset(64, g)
    assert bool((torch.abs(down.data["q"][:, 1] - torch.pi) < 0.3).all())
    assert not down.done.any()
    tilted = torch.tensor([[0.0, 1.0, 0.0, 0.0]])
    assert CartpoleBalance()._state(tilted).done.item() == 1.0
    assert CartpoleSwingup()._state(tilted).done.item() == 0.0
    with pytest.raises(ValueError, match="generator"):
        JoystickLocomotion().step(JoystickLocomotion().reset(2, g), torch.zeros(2, 8))


def locomotion_net(g):
    """The locomotion row's Concat / Parallel actor-critic at narrow widths."""
    enc = Concat.create(
        proprio=Dense.create(14, 16, g, torch.relu), command=Dense.create(3, 8, g, torch.relu)
    )
    actor = Sequential.create([
        Dense.create(24, 16, g, torch.relu), Dense.create(16, 16, g),
        NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    critic = Parallel.create(
        tracking=make_mlp([24, 16, 1], g, activation_last_layer=False),
        penalty=make_mlp([24, 16, 1], g, activation_last_layer=False),
    )
    return Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])


@pytest.mark.parametrize("case", list(CASES))
def test_ppo_step_on_the_cpu(case):
    """Each env through one ``ppo_step`` at a small size: 8 envs, T=4,
    finite losses, parameters moved, no kernel launched on CPU tensors."""
    env = EpisodeWrapper(CASES[case][1](), max_len=500)
    g = torch.Generator().manual_seed(0)
    if case == "locomotion":
        net, combine, critic_key = locomotion_net(g), True, "losses/critic/tracking/mean"
    else:
        net = make_mlp_actor_critic(env.observation_size, env.action_size, [16, 16], [16], 0,
                                    entropy_weight=1e-3)
        combine, critic_key = False, "losses/critic/mean"
    config = PPOConfig(n_envs=8, rollout_length=4, n_epochs=2, n_minibatches=2,
                       combine_advantages=combine)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(env, net, 8, seed=0, optimizer=optimizer, device="cpu")
    before = [p.detach().clone() for p in ts.networks.parameters()]
    launches = gae_cuda.launches
    ts, metrics = ppo_step(env, ts, config, optimizer)
    assert gae_cuda.launches == launches
    assert ts.steps_taken == 32
    for key in ("losses/actor/mean", critic_key):
        assert torch.isfinite(metrics[key]), key
    assert any(not torch.equal(a, b) for a, b in zip(before, ts.networks.parameters()))
