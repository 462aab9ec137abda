"""The test dummies and ``RewardScalingWrapper`` of the port against the
JAX package's, and the template gates they exist for.

Each dummy env steps ``B`` envs at once with the JAX env's draws injected
(the JAX envs split keys carried in their state, or drawn from the reset
key: ``nnx_ppo_tpu/test_dummies/*.py``); each dummy net runs on the same
inputs and weights as the JAX net. Then the gates of the JAX suite, on the
port's own rollout: the ``DummyCounter`` carry-reset exactness (``rewards.sum()
== T·B`` to the integer, ``tests/test_rollout.py``), the T·B forward
count of ``RepeatAndCountNet``, the reset schedule of ``MockEnv``, the
eval latch, dict observations, actions and rewards through the PPO loss
(against the JAX loss on a JAX rollout) and through ``ppo_step``, and a
learning gate on ``MoveToCenterEnv`` through ``train_ppo``.

Tolerances: the envs are elementwise float32 (sin, cos, exp, sqrt, tanh,
whose last bits differ between XLA's CPU kernels and PyTorch's): 1e-6
absolute; counters, flags and the DummyCounter reward exactly. The nets'
matmuls have 4 or 8 terms: 1e-6. The loss and its gradients: rtol 1e-4 /
atol 1e-6, as for the flagship loss (float32 sums over T·B terms in
another order).
"""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.algorithms import new_training_state as jax_new_training_state
from nnx_ppo_tpu.algorithms import unroll_env as jax_unroll_env
from nnx_ppo_tpu.algorithms.ppo import ppo_loss as jax_ppo_loss
from nnx_ppo_tpu.algorithms.types import LoggingLevel as JaxLoggingLevel
from nnx_ppo_tpu.core.struct import partition_params
from nnx_ppo_tpu import test_dummies as jax_dummies
from nnx_ppo_tpu.wrappers import RewardScalingWrapper as JaxRewardScalingWrapper
from nnx_ppo_tpu_torch.algorithms import (
    EvalConfig,
    LoggingLevel,
    PPOConfig,
    TrainConfig,
    Transition,
    make_optimizer,
    new_training_state,
    ppo_loss,
    ppo_step,
    train_ppo,
)
from nnx_ppo_tpu_torch.algorithms.rollout import eval_rollout, unroll_env
from nnx_ppo_tpu_torch.convert import load_jax_leaves, to_torch
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import PPONetworkOutput, make_mlp_actor_critic
from nnx_ppo_tpu_torch.ops.gae import gae_cuda
from nnx_ppo_tpu_torch.test_dummies import (
    DictObsActEnv,
    DictObsActNet,
    DummyCounterEnv,
    DummyCounterNet,
    MockEnv,
    MoveFromCenterEnv,
    MoveToCenterEnv,
    ParrotEnv,
    RepeatAndCountNet,
    TwoArmEnv,
    TwoArmNet,
)
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper, RewardScalingWrapper

torch.set_num_threads(1)

B, N_STEPS = 6, 7


def t(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_tree_close(got, want, atol, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree_close(got[k], want[k], atol, f"{what}/{k}")
        return
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    if atol == 0 or want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def assert_state_close(got, want, what, data_keys=()):
    assert_tree_close(got.obs, want.obs, 1e-6, f"{what} obs")
    assert_tree_close(got.reward, want.reward, 1e-6, f"{what} reward")
    assert_tree_close(got.done, want.done, 0, f"{what} done")
    for k in data_keys:
        assert_tree_close(got.data[k], want.data[k], 1e-6, f"{what} data/{k}")


# -- the dummy envs against the JAX ones, draws injected ---------------------------

# name -> (JAX env, port env, reset draws of one env from its key, step
# draws of one env from its JAX state or None, action maker, data keys).


def _next_obs_key(state):
    return jax.random.split(state.data["key"])[0]


def _actions(shape):
    def make(rng):
        return rng.uniform(-1.3, 1.3, shape).astype(np.float32)

    return make


ENV_CASES = {
    "mock": (
        lambda: jax_dummies.MockEnv(3, 3, max_steps=4), lambda: MockEnv(3, 3, max_steps=4),
        lambda env, k: jax.random.normal(jax.random.split(k)[0], (3,)),
        lambda env, s: jax.random.normal(_next_obs_key(s), (3,)),
        _actions((3,)), ("ticks",),
    ),
    "parrot": (
        lambda: jax_dummies.ParrotEnv((3,)), lambda: ParrotEnv((3,)),
        lambda env, k: jax.random.normal(jax.random.split(k)[0], (3,)),
        lambda env, s: jax.random.normal(_next_obs_key(s), (3,)),
        _actions((3,)), (),
    ),
    "move_to_center": (
        jax_dummies.MoveToCenterEnv, MoveToCenterEnv,
        lambda env, k: jax.random.uniform(k, (2,)), None, _actions((2,)), ("pos",),
    ),
    "move_from_center": (
        jax_dummies.MoveFromCenterEnv, MoveFromCenterEnv,
        lambda env, k: jax.random.uniform(k, (2,)), None, _actions((2,)), ("pos",),
    ),
    "dict_obs_act": (
        jax_dummies.DictObsActEnv, DictObsActEnv,
        lambda env, k: jax.random.uniform(k, (2,), minval=-1.0, maxval=1.0), None,
        lambda rng: {"force": rng.uniform(-1.0, 1.0, (2,)).astype(np.float32)}, (),
    ),
    "two_arm": (
        jax_dummies.TwoArmEnv, TwoArmEnv,
        lambda env, k: {
            "arm1": jax.random.uniform(k, (2,), minval=-1.0, maxval=1.0),
            "arm2": jax.random.uniform(jax.random.fold_in(k, 1), (2,), minval=-1.0, maxval=1.0),
        },
        None,
        lambda rng: {a: rng.uniform(-25.0, 25.0, (2,)).astype(np.float32) for a in ("arm1", "arm2")},
        (),
    ),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_dummy_env_matches_jax_with_injected_draws(case):
    make_jax, make_port, reset_draws, step_draws, make_action, data_keys = ENV_CASES[case]
    jax_env, env = make_jax(), make_port()
    keys = jax.random.split(jax.random.key(4), B)
    rng = np.random.RandomState(0)
    actions = [jax.tree.map(lambda *xs: np.stack(xs), *[make_action(rng) for _ in range(B)])
               for _ in range(N_STEPS)]

    want = jax.vmap(jax_env.reset)(keys)
    state = env._reset_from(jax.tree.map(t, np_tree(jax.vmap(lambda k: reset_draws(jax_env, k))(keys))))
    assert_state_close(state, want, "reset", data_keys)
    jax_step = jax.jit(jax.vmap(jax_env.step))
    dones = 0
    for n in range(N_STEPS):
        action = jax.tree.map(t, actions[n])
        if step_draws is not None:
            draws = np_tree(jax.vmap(lambda s: step_draws(jax_env, s))(want))
            state = env._step_from(state, action, t(draws)) if case == "parrot" else \
                env._step_from(state, t(draws))
        else:
            state = env.step(state, action)
        want = jax_step(want, jax.tree.map(jnp.asarray, actions[n]))
        assert_state_close(state, want, f"step {n}", data_keys)
        dones += int(np.asarray(want.done).sum())
    if case in ("mock", "two_arm", "move_to_center", "move_from_center"):
        assert 0 < dones < N_STEPS * B  # some episodes end, some go on


def test_dummy_counter_env_and_net_match_jax():
    """The counter env with the JAX reset draws, stepped with the JAX
    DummyCounterNet's actions and with one wrong action per step; reward,
    done and counters exactly."""
    jax_env, env = jax_dummies.DummyCounterEnv(), DummyCounterEnv()
    jax_net, net = jax_dummies.DummyCounterNet(), DummyCounterNet()
    keys = jax.random.split(jax.random.key(2), B)
    want = jax.vmap(jax_env.reset)(keys)
    state = env._reset_from(t(jax.vmap(lambda k: jax.random.randint(k, (), 3, 10))(keys)))
    assert_state_close(state, want, "reset", ("current_step", "reset_step"))
    jax_carry, carry = jax_net.initialize_state(B), net.initialize_state(B)
    for n in range(N_STEPS):
        jax_out, out = jax_net(jax_carry, want.obs), net(carry, state.obs)
        assert_tree_close(out.output.actions, jax_out.output.actions, 0, "actions")
        assert_tree_close(out.next_state, np_tree(jax_out.next_state), 0, "carry")
        wrong = np.zeros((B, 1), np.float32)
        wrong[n % B] = -1.0  # one env's action misses its count
        want = jax.vmap(jax_env.step)(want, jax_out.output.actions + wrong)
        state = env.step(state, out.output.actions + t(wrong))
        assert_state_close(state, want, f"step {n}", ("current_step", "reset_step"))
        jax_carry, carry = jax_out.next_state, out.next_state
    reset = net.reset_state(carry)
    assert all(int(x.abs().sum()) == 0 for x in jax.tree.leaves(reset, is_leaf=torch.is_tensor))


def test_repeat_and_count_net_matches_jax():
    jax_net, net = jax_dummies.RepeatAndCountNet(), RepeatAndCountNet()
    obs = np.random.RandomState(1).randn(B, 3).astype(np.float32)
    jax_out = jax_net(jax_net.initialize_state(B), jnp.asarray(obs))
    out = net(net.initialize_state(B), t(obs))
    for name in ("actions", "loglikelihoods", "value_estimates"):
        assert_tree_close(getattr(out.output, name), getattr(jax_out.output, name), 0, name)
    assert_tree_close(out.next_state, np_tree(jax_out.next_state), 0, "carry")
    assert net.reset_state(out.next_state) is out.next_state  # counting survives resets


NET_CASES = {
    "dict_obs_act": (jax_dummies.DictObsActNet, DictObsActNet,
                     lambda rng: {"pos": rng.randn(B, 2), "vel": rng.randn(B, 2)}),
    "two_arm": (jax_dummies.TwoArmNet, TwoArmNet,
                lambda rng: {a: {"pos": rng.randn(B, 2), "vel": rng.randn(B, 2)}
                             for a in ("arm1", "arm2")}),
}


def port_net(case, jax_net):
    net = NET_CASES[case][1].create(torch.Generator().manual_seed(0))
    return load_jax_leaves(net, np_tree(jax_net))


@pytest.mark.parametrize("case", list(NET_CASES))
def test_dict_nets_match_jax_on_the_same_weights(case):
    make_jax, _, make_obs = NET_CASES[case]
    jax_net = make_jax.create(jax.random.key(0))
    net = port_net(case, jax_net)
    obs = jax.tree.map(lambda x: x.astype(np.float32), make_obs(np.random.RandomState(2)))
    jax_out = jax_net(jax_net.initialize_state(B), jax.tree.map(jnp.asarray, obs))
    out = net(net.initialize_state(B), jax.tree.map(t, obs))
    for name in ("actions", "loglikelihoods", "value_estimates"):
        assert_tree_close(getattr(out.output, name), getattr(jax_out.output, name), 1e-6, name)
    if case == "dict_obs_act":
        # The replay consumes the stored pre-squash action.
        assert_tree_close(out.rollout_extras, jax_out.rollout_extras, 1e-6, "extras")
        replay = net(net.initialize_state(B), jax.tree.map(t, obs),
                     {"force": torch.zeros(B, 2)})
        assert torch.equal(replay.output.actions["force"], torch.zeros(B, 2))
    assert net.replay_time_static


# -- the template gates on the port's own rollouts ---------------------------------


def test_dummy_counter_carry_resets_are_exact():
    """Net carry resets in lockstep with env resets, so every action
    matches the steps since reset: total reward == T·B to the integer."""
    n_envs, T = 16, 50
    env, net = DummyCounterEnv(), DummyCounterNet()
    g = torch.Generator().manual_seed(0)
    _, _, data = unroll_env(env, env.reset(n_envs, g), net, net.initialize_state(n_envs), T, g)
    assert data.done.any()
    assert int(data.rewards.sum().item()) == T * n_envs
    assert data.rewards.sum().item() == float(T * n_envs)


def test_network_called_exactly_t_times_per_env_and_mock_resets_on_schedule():
    n_envs, T = 16, 50
    env, net = MockEnv(obs_size=3, action_size=3, max_steps=4), RepeatAndCountNet()
    g = torch.Generator().manual_seed(0)
    final, _, data = unroll_env(env, env.reset(n_envs, g), net, net.initialize_state(n_envs), T, g)
    assert int(final["n_calls"].sum()) == T * n_envs
    assert data.obs.shape == (T, n_envs, 3) and data.rewards.shape == (T, n_envs)
    assert data.done.dtype == torch.bool and data.rewards.sum().item() == T * n_envs
    env5 = MockEnv(obs_size=2, action_size=2, max_steps=5)
    _, _, data = unroll_env(env5, env5.reset(4, g), net, net.initialize_state(4), 20, g)
    assert int(data.done.sum()) == 4 * 4  # done every 5 steps


def test_eval_rollout_latches_and_parrots():
    g = torch.Generator().manual_seed(0)
    metrics = eval_rollout(MoveFromCenterEnv(), RepeatAndCountNet(), 8, 30, g,
                           logging_percentiles=(0, 50, 100))
    assert 0 <= metrics["lifespan_mean"].item() <= 30
    assert metrics["lifespan/p0"].item() <= metrics["lifespan/p100"].item()
    metrics = eval_rollout(ParrotEnv(obs_size=(3,)), RepeatAndCountNet(), 8, 20, g)
    assert metrics["episode_reward/mean"].item() > 19.0  # action = previous obs


# -- dict obs / actions / rewards through the loss and ppo_step -------------------


def port_transition(tr):
    tr = np_tree(tr)
    out = tr.network_output
    return Transition(
        obs=to_torch(tr.obs),
        network_output=PPONetworkOutput(
            actions=to_torch(out.actions),
            loglikelihoods=to_torch(out.loglikelihoods),
            value_estimates=to_torch(out.value_estimates),
        ),
        rewards=to_torch(tr.rewards),
        done=to_torch(tr.done),
        truncated=to_torch(tr.truncated),
        next_obs=to_torch(tr.next_obs),
        metrics={},
        rollout_extras=to_torch(tr.rollout_extras),
    )


LOSS_KW = dict(clip_range=0.2, normalize_advantages=True, discounting_factor=0.99,
               gae_lambda=0.95, critic_loss_weight=1.0)
DICT_CASES = {
    "dict_obs_act": (jax_dummies.DictObsActEnv, False),
    "two_arm": (jax_dummies.TwoArmEnv, False),
    "two_arm_combined": (jax_dummies.TwoArmEnv, True),
}


@pytest.mark.parametrize("case", list(DICT_CASES))
def test_dict_loss_and_gradients_match_jax(case):
    """The PPO loss on a JAX rollout of the dict env: dict obs, dict
    actions (DictObsActEnv: the stored pre-squash action replays), dict
    rewards with a value head each (TwoArmEnv, per key or with combined
    advantages)."""
    make_env, combine = DICT_CASES[case]
    net_case = "two_arm" if case.startswith("two_arm") else case
    jax_env, T = make_env(), 5
    jax_net = NET_CASES[net_case][0].create(jax.random.key(1))
    ts = jax_new_training_state(jax_env, jax_net, 8, seed=3)
    _, _, rollout = jax.jit(jax_unroll_env, static_argnums=(0, 4))(
        jax_env, ts.env_states, ts.networks, ts.network_states, T, jax.random.key(5)
    )
    params, rest = partition_params(jax_net)
    kw = dict(LOSS_KW, combine_advantages=combine)

    def loss_fn(p):
        return jax_ppo_loss(p, rest, jax_net.initialize_state(8), rollout,
                            logging_level=JaxLoggingLevel.LOSSES, fused_replay=True, **kw)

    (jax_loss, jax_metrics), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    net = port_net(net_case, jax_net)
    loss, metrics = ppo_loss(net, net.initialize_state(8), port_transition(rollout),
                             logging_level=LoggingLevel.LOSSES, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_loss), rtol=1e-4, atol=1e-6)
    for key in ("losses/actor", "losses/critic"):
        assert_tree_close(jax.tree.map(lambda x: x.detach(), metrics[key]),
                          np_tree(jax_metrics[key]), 1e-6, key)
    for name, p in net.named_parameters():
        want = np.asarray(getattr(jax_grads, name))
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)
    assert np.abs(np.asarray(jax_grads.critic_kernel)).max() > 0


@pytest.mark.parametrize("case", list(DICT_CASES))
def test_dict_ppo_step_on_the_cpu(case):
    env_cls, net_cls = (DictObsActEnv, DictObsActNet) if case == "dict_obs_act" else \
        (TwoArmEnv, TwoArmNet)
    config = PPOConfig(n_envs=8, rollout_length=5, n_epochs=2, n_minibatches=2,
                       combine_advantages=DICT_CASES[case][1])
    optimizer = make_optimizer(config.learning_rate)
    env = env_cls()
    net = net_cls.create(torch.Generator().manual_seed(0))
    ts = new_training_state(env, net, 8, seed=0, optimizer=optimizer, device="cpu")
    critic_before = ts.networks.critic_kernel.detach().clone()
    launches = gae_cuda.launches
    for _ in range(2):
        ts, metrics = ppo_step(env, ts, config, optimizer)
    assert gae_cuda.launches == launches
    assert ts.steps_taken == 2 * 8 * 5
    keys = ["losses/critic/mean", "losses/actor/mean"] if case == "dict_obs_act" else [
        f"losses/{kind}/{arm}/mean" for kind in ("critic", "actor") for arm in ("arm1", "arm2")
    ]
    for key in keys:
        assert torch.isfinite(metrics[key]), key
    assert not torch.equal(critic_before, ts.networks.critic_kernel)


# -- RewardScalingWrapper ------------------------------------------------------------


def test_reward_scaling_matches_jax():
    """Every reward leaf scaled in reset and step (TwoArmEnv: a dict
    reward); everything else passes through."""
    jax_env = JaxRewardScalingWrapper(jax_dummies.TwoArmEnv(), 2.5)
    env = RewardScalingWrapper(TwoArmEnv(), 2.5)
    keys = jax.random.split(jax.random.key(7), B)
    want = jax.vmap(jax_env.reset)(keys)
    draws = ENV_CASES["two_arm"][2]
    state = env._reset_from(jax.tree.map(t, np_tree(jax.vmap(lambda k: draws(None, k))(keys))))
    state = state.replace(reward={k: 2.5 * r for k, r in state.reward.items()})
    assert_state_close(state, want, "reset")
    action = {a: np.full((B, 2), 0.5, np.float32) for a in ("arm1", "arm2")}
    want = jax.vmap(jax_env.step)(want, jax.tree.map(jnp.asarray, action))
    state = env.step(state, jax.tree.map(t, action))
    assert_state_close(state, want, "step")
    g = torch.Generator().manual_seed(0)
    plain, scaled = CartpoleBalance(), RewardScalingWrapper(CartpoleBalance(), -0.5)
    a, b = plain.reset(4, g), scaled.reset(4, torch.Generator().manual_seed(0))
    assert torch.equal(b.reward, -0.5 * a.reward) and torch.equal(b.obs, a.obs)
    assert (scaled.observation_size, scaled.action_size) == (5, 1)


def test_reward_scaling_delegates_attributes_with_the_jax_guard():
    ours = RewardScalingWrapper(EpisodeWrapper(CartpoleBalance(), 100), 2.0)
    theirs = JaxRewardScalingWrapper(jax_dummies.MoveToCenterEnv(), 2.0)
    assert ours.max_len == 100 and ours.x_limit == 2.4  # through both wrappers
    for name in ("reward_scale", "reset", "no_such_attribute"):
        assert hasattr(ours, name) == hasattr(theirs, name), name
    for wrapper in (ours, theirs):
        bare = type(wrapper).__new__(type(wrapper))
        with pytest.raises(AttributeError):
            bare.env
        clone = copy.deepcopy(wrapper)
        assert clone.reward_scale == 2.0 and clone.env is not wrapper.env
        assert pickle.loads(pickle.dumps(wrapper)).reward_scale == 2.0


# -- a learning gate ---------------------------------------------------------------


def test_train_ppo_learns_move_to_center_on_the_cpu():
    """train_ppo on MoveToCenterEnv (50-step episodes) on the CPU: the
    deterministic eval's mean episode reward (at most 50) rises from its
    start by more than 15 within 48 iterations of 64 envs × 16 steps
    (seed 0 reads 14.2, 29.8, 36.6 at 0, 24 and 48 iterations)."""
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    net = make_mlp_actor_critic(2, 2, [32, 32], [32, 32], 0, entropy_weight=3e-3, min_std=0.05)
    per_iter = 64 * 16
    config = TrainConfig(
        ppo=PPOConfig(n_envs=64, rollout_length=16, total_steps=48 * per_iter,
                      learning_rate=1e-3, gradient_clipping=1.0),
        eval=EvalConfig(n_envs=64, max_episode_length=50, every_steps=24 * per_iter,
                        logging_percentiles=None),
        seed=0,
    )
    res = train_ppo(env, net, config, device="cpu")
    rewards = [row["episode_reward/mean"] for row in res.eval_history]
    assert len(rewards) == 3 and all(np.isfinite(rewards))
    assert rewards[-1] > rewards[0] + 15.0, rewards
