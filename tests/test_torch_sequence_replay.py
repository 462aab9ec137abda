"""The sequential replay of nnx_ppo_tpu_torch against nnx_ppo_tpu's: the
default time scan of a module with a carry, ``ppo_loss`` of a GRU
actor-critic in both replay modes, fused against unfused in the port,
and one ``ppo_step`` of the GRU net.

The JAX package makes the rollouts (its draws cannot be reproduced by a
torch.Generator); rollout, carries and weights are carried across as
numpy. Tolerances are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_networks import carried_across, np_leaves
from test_torch_ppo import port_transition

from nnx_ppo_tpu.algorithms import PPOConfig as JaxPPOConfig
from nnx_ppo_tpu.algorithms import make_optimizer as jax_make_optimizer
from nnx_ppo_tpu.algorithms import new_training_state as jax_new_training_state
from nnx_ppo_tpu.algorithms import rollout as jax_rollout
from nnx_ppo_tpu.algorithms.ppo import ppo_loss as jax_ppo_loss
from nnx_ppo_tpu.algorithms.ppo import ppo_step as jax_ppo_step
from nnx_ppo_tpu.algorithms.types import LoggingLevel as JaxLoggingLevel
from nnx_ppo_tpu.core.struct import partition_params
from nnx_ppo_tpu.envs import CartpoleBalance as JaxCartpoleBalance
from nnx_ppo_tpu.networks import GRU as JaxGRU
from nnx_ppo_tpu.networks import Dense as JaxDense
from nnx_ppo_tpu.networks import NormalTanhSampler as JaxSampler
from nnx_ppo_tpu.networks import PPOAdapter as JaxPPOAdapter
from nnx_ppo_tpu.networks import Sequential as JaxSequential
from nnx_ppo_tpu.parallel.permutation import minibatch_permutations
from nnx_ppo_tpu.test_dummies import DummyCounterNet as JaxDummyCounterNet
from nnx_ppo_tpu.wrappers import EpisodeWrapper as JaxEpisodeWrapper
from nnx_ppo_tpu_torch.algorithms import (
    LoggingLevel,
    PPOConfig,
    make_optimizer,
    new_training_state,
    ppo_loss,
    ppo_multi_step,
    ppo_update,
)
from nnx_ppo_tpu_torch.convert import to_torch
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import GRU, Dense, NormalTanhSampler, PPOAdapter, Sequential
from nnx_ppo_tpu_torch.test_dummies import DummyCounterNet
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

N_ENVS, T, H = 8, 6, 8
LOSS_KW = dict(
    clip_range=0.2,
    normalize_advantages=True,
    combine_advantages=False,
    discounting_factor=0.99,
    gae_lambda=0.95,
    critic_loss_weight=1.0,
)


def jax_gru_net(seed=0):
    k = jax.random.split(jax.random.key(seed), 5)
    return JaxPPOAdapter.create(
        action=JaxSequential.create([
            JaxGRU.create(5, H, k[0]), JaxDense.create(H, 2, k[1]),
            JaxSampler.create(k[2], entropy_weight=1e-2),
        ]),
        value=JaxSequential.create([JaxGRU.create(5, H, k[3]), JaxDense.create(H, 1, k[4])]),
    )


def gru_net(seed=0):
    g = torch.Generator().manual_seed(seed)
    return PPOAdapter.create(
        action=Sequential.create([
            GRU.create(5, H, g), Dense.create(H, 2, g), NormalTanhSampler.create(entropy_weight=1e-2),
        ]),
        value=Sequential.create([GRU.create(5, H, g), Dense.create(H, 1, g)]),
    )


@pytest.fixture(scope="module")
def gru_setup():
    """A JAX GRU training state warmed by one rollout (so the carries the
    loss starts from are not zero) and the rollout its first ppo_step
    makes; the 4-step time limit puts resets and truncations inside T."""
    env = JaxEpisodeWrapper(JaxCartpoleBalance(), max_len=4)
    net = jax_gru_net()
    ts = jax_new_training_state(env, net, N_ENVS, seed=3, learning_rate=3e-4)
    unroll = jax.jit(jax_rollout.unroll_env, static_argnums=(0, 4))
    net_state, env_state, _ = unroll(
        env, ts.env_states, ts.networks, ts.network_states, T, jax.random.key(11)
    )
    ts = ts.replace(network_states=net_state, env_states=env_state)
    reset_key, perm_key, _ = jax.random.split(ts.rng_key, 3)
    _, _, rollout_data = unroll(env, ts.env_states, ts.networks, ts.network_states, T, reset_key)
    config = JaxPPOConfig(n_envs=N_ENVS, rollout_length=T, learning_rate=3e-4, n_epochs=2,
                          n_minibatches=2)
    selectors = minibatch_permutations(perm_key, N_ENVS, config.n_epochs, config.n_minibatches)
    return env, config, ts, rollout_data, np.asarray(selectors)


def port_carry(jax_carry):
    """JAX carries -> the port's: the samplers' per-env keys become None
    (the port's samplers keep no carry)."""
    return to_torch(np_leaves(jax_carry))


def test_rollout_has_resets_and_nonzero_carries(gru_setup):
    _, _, ts, rollout_data, _ = gru_setup
    assert bool(rollout_data.done.any()) and bool(rollout_data.truncated.any())
    assert float(jnp.abs(ts.network_states["action"][0]).min()) > 0


def test_default_replay_is_the_time_scan():
    """A module with a carry and no replay of its own (DummyCounterNet)
    replays by the step-wise scan, resetting after done steps, as JAX's
    default ``replay_sequence`` does: outputs and final carry equal."""
    rng = np.random.RandomState(0)
    T_, B_ = 9, 5
    done = rng.rand(T_, B_) < 0.3
    obs = np.zeros((T_, B_, 1), np.float32)
    jax_net = JaxDummyCounterNet()
    want_out, want_reg, want_final = jax_net.replay_sequence(
        jax_net.initialize_state(B_), jnp.asarray(obs), jnp.asarray(done), None
    )
    net = DummyCounterNet()
    got_out, got_reg, got_final = net.replay_sequence(
        net.initialize_state(B_), torch.from_numpy(obs), torch.from_numpy(done), None
    )
    np.testing.assert_array_equal(got_out.actions.numpy(), np.asarray(want_out.actions))
    np.testing.assert_array_equal(
        got_final["counter_state"]["counter"].numpy(),
        np.asarray(want_final["counter_state"]["counter"]),
    )
    assert got_reg.shape == tuple(np.asarray(want_reg).shape) == (T_, B_)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused_scan", "fused"])
def test_gru_ppo_loss_and_gradients_match_jax(gru_setup, fused):
    """JAX's ppo_loss against the port's in the same replay mode, from
    the warmed carries. rtol 1e-4 / atol 1e-6: float32 sums over T·B
    terms, reduced in another order, through T steps of two GRUs."""
    _, _, ts, rollout_data, _ = gru_setup
    params, rest = partition_params(ts.networks)
    params = jax.tree.map(lambda p: p * 1.05, params)
    level = JaxLoggingLevel.LOSSES | JaxLoggingLevel.CRITIC_EXTRA

    def loss_fn(p):
        return jax_ppo_loss(p, rest, ts.network_states, rollout_data, logging_level=level,
                            fused_replay=fused, **LOSS_KW)

    (jax_loss, jax_metrics), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    net = carried_across(ts.networks, gru_net())
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(1.05)
    loss, metrics = ppo_loss(
        net, port_carry(ts.network_states), port_transition(rollout_data),
        logging_level=LoggingLevel.LOSSES | LoggingLevel.CRITIC_EXTRA, fused_replay=fused,
        **LOSS_KW,
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_loss), rtol=1e-4, atol=1e-6)
    for key in ("losses/actor", "losses/critic", "losses/regularization", "losses/critic_R^2"):
        np.testing.assert_allclose(metrics[key].detach().numpy(), np.asarray(jax_metrics[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    jax_grad_leaves = jax.tree.leaves(jax_grads)
    torch_grads = [p.grad.numpy() for p in net.parameters()]
    assert len(jax_grad_leaves) == len(torch_grads) == 10
    for g_jax, g_torch in zip(jax_grad_leaves, torch_grads):
        np.testing.assert_allclose(g_torch, np.asarray(g_jax), rtol=1e-4, atol=1e-6)


def test_fused_equals_unfused_in_the_port(gru_setup):
    """The layer-wise replay (hoisted GRU projections) against the
    whole-net step scan, both in the port: rtol 1e-5 / atol 1e-6 on the
    loss, 1e-4 / 1e-6 on gradients (float32 reassociation only)."""
    _, _, ts, rollout_data, _ = gru_setup
    results = []
    for fused in (True, False):
        net = carried_across(ts.networks, gru_net())
        loss, _ = ppo_loss(net, port_carry(ts.network_states), port_transition(rollout_data),
                           logging_level=LoggingLevel.NONE, fused_replay=fused, **LOSS_KW)
        loss.backward()
        results.append((loss.item(), [p.grad for p in net.parameters()]))
    (loss_f, grads_f), (loss_s, grads_s) = results
    np.testing.assert_allclose(loss_f, loss_s, rtol=1e-5, atol=1e-6)
    for a, b in zip(grads_f, grads_s):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused_scan"])
def test_gru_update_phase_matches_jax_ppo_step(gru_setup, fused):
    """One whole update phase: JAX's ppo_step against ppo_update on the
    JAX rollout with the JAX minibatch selectors, from the warmed
    carries. rtol 1e-4 / atol 2e-6 on params, as for the flagship (4 adam
    updates of lr 3e-4)."""
    env, config, ts, rollout_data, selectors = gru_setup
    config = dataclasses.replace(config, fused_replay=fused)
    jax_optimizer = jax_make_optimizer(config.learning_rate)
    new_ts, jax_metrics = jax.jit(jax_ppo_step, static_argnums=(0, 2, 3))(
        env, ts, config, jax_optimizer
    )
    net = carried_across(ts.networks, gru_net())
    optimizer = make_optimizer(3e-4)
    opt_state = optimizer.init(net.parameters())
    port_config = PPOConfig(n_envs=N_ENVS, rollout_length=T, learning_rate=3e-4, n_epochs=2,
                            n_minibatches=2, fused_replay=fused)
    loss_metrics = ppo_update(
        net, opt_state, port_carry(ts.network_states), port_transition(rollout_data),
        port_config, optimizer, selectors=torch.tensor(selectors, dtype=torch.long),
    )
    np.testing.assert_allclose(loss_metrics["losses/actor"].mean().item(),
                               float(jax_metrics["losses/actor/mean"]), rtol=1e-3, atol=1e-6)
    new_params, _ = partition_params(new_ts.networks)
    assert opt_state.param_groups[0]["update_count"] == 4
    for p_jax, p_torch in zip(jax.tree.leaves(new_params), net.parameters()):
        np.testing.assert_allclose(p_torch.detach().numpy(), np.asarray(p_jax), rtol=1e-4, atol=2e-6)


def test_gru_net_trains_unfused_on_the_cpu():
    """PPOConfig(fused_replay=False) trains a GRU net through ppo_step:
    finite losses, parameters moved, and the same first loss as the
    fused replay (both start from the same seed)."""
    env = EpisodeWrapper(CartpoleBalance(), max_len=10)
    losses = {}
    for fused in (True, False):
        config = PPOConfig(n_envs=N_ENVS, rollout_length=T, n_epochs=2, n_minibatches=2,
                           fused_replay=fused, learning_rate=1e-3)
        optimizer = make_optimizer(config.learning_rate)
        ts = new_training_state(env, gru_net(), N_ENVS, seed=2, optimizer=optimizer, device="cpu")
        before = [p.detach().clone() for p in ts.networks.parameters()]
        ts, metrics = ppo_multi_step(env, ts, config, optimizer, n_steps=2, return_history=True)
        assert all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values())
        assert not all(torch.equal(a, b) for a, b in zip(before, ts.networks.parameters()))
        assert ts.network_states["action"][0].shape == (N_ENVS, H)
        losses[fused] = metrics["losses/actor/mean"]
    torch.testing.assert_close(losses[True][0], losses[False][0], rtol=1e-5, atol=1e-6)
