"""PPO parity and smoke tests for nnx_ppo_tpu_torch against nnx_ppo_tpu.

The JAX package makes the rollout (its draws cannot be reproduced by a
torch.Generator), the rollout and weights are carried across as numpy,
and both sides compute the loss, the gradients and a whole update phase
on them. Tolerances are stated per test.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.algorithms import PPOConfig as JaxPPOConfig
from nnx_ppo_tpu.algorithms import make_optimizer as jax_make_optimizer
from nnx_ppo_tpu.algorithms import new_training_state as jax_new_training_state
from nnx_ppo_tpu.algorithms import rollout as jax_rollout
from nnx_ppo_tpu.algorithms.ppo import ppo_loss as jax_ppo_loss
from nnx_ppo_tpu.algorithms.ppo import ppo_step as jax_ppo_step
from nnx_ppo_tpu.algorithms.types import LoggingLevel as JaxLoggingLevel
from nnx_ppo_tpu.core.struct import partition_params
from nnx_ppo_tpu.envs import CartpoleBalance as JaxCartpoleBalance
from nnx_ppo_tpu.networks import make_mlp_actor_critic as jax_make_mlp_actor_critic
from nnx_ppo_tpu.parallel.permutation import minibatch_permutations
from nnx_ppo_tpu.wrappers import EpisodeWrapper as JaxEpisodeWrapper
from nnx_ppo_tpu_torch.algorithms import (
    EvalConfig,
    LoggingLevel,
    PPOConfig,
    TrainConfig,
    Transition,
    make_optimizer,
    new_training_state,
    ppo_loss,
    ppo_multi_step,
    ppo_step,
    ppo_update,
    train_ppo,
)
from nnx_ppo_tpu_torch.convert import load_jax_leaves, to_torch
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import PPONetworkOutput, make_mlp_actor_critic
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

N_ENVS, T = 16, 8
ACTOR, CRITIC = [16, 16], [32]


def np_leaves(tree):
    return jax.tree.map(
        lambda x: None if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else np.asarray(x),
        tree,
    )


def port_network(jax_net):
    net = make_mlp_actor_critic(5, 1, ACTOR, CRITIC, 0, entropy_weight=1e-3)
    params, rest = partition_params(jax_net)
    load_jax_leaves(net, np_leaves(params))
    load_jax_leaves(net, np_leaves(rest))
    return net


def port_transition(tr):
    tr = np_leaves(tr)
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


@pytest.fixture(scope="module")
def jax_setup():
    """A JAX training state and the rollout its first ppo_step makes."""
    env = JaxEpisodeWrapper(JaxCartpoleBalance(), max_len=12)  # truncations inside T
    net = jax_make_mlp_actor_critic(
        5, 1, ACTOR, CRITIC, jax.random.key(0), normalize_obs=True, entropy_weight=1e-3
    )
    config = JaxPPOConfig(n_envs=N_ENVS, rollout_length=T, learning_rate=3e-4)
    ts = jax_new_training_state(env, net, N_ENVS, seed=3, learning_rate=3e-4)
    # ppo_step's own key split (nnx_ppo_tpu/algorithms/ppo.py:368).
    reset_key, perm_key, _ = jax.random.split(ts.rng_key, 3)
    _, _, rollout_data = jax.jit(
        jax_rollout.unroll_env, static_argnums=(0, 4)
    )(env, ts.env_states, ts.networks, ts.network_states, T, reset_key)
    selectors = minibatch_permutations(perm_key, N_ENVS, config.n_epochs, config.n_minibatches)
    return env, config, ts, rollout_data, np.asarray(selectors)


def test_rollout_has_terminals_and_truncations(jax_setup):
    _, _, _, rollout_data, _ = jax_setup
    assert bool(rollout_data.done.any()) and bool(rollout_data.truncated.any())


LOSS_KW = dict(
    clip_range=0.2,
    normalize_advantages=True,
    combine_advantages=False,
    discounting_factor=0.99,
    gae_lambda=0.95,
    critic_loss_weight=1.0,
)


def test_ppo_loss_and_gradients_match_jax(jax_setup):
    """Tolerance rtol 1e-4 / atol 1e-6: the loss and its gradients are
    float32 sums over T·B terms, reduced in a different order; the
    normalized advantages divide by a population std computed the same
    way on both sides."""
    _, _, ts, rollout_data, _ = jax_setup
    params, rest = partition_params(ts.networks)
    level = JaxLoggingLevel.LOSSES | JaxLoggingLevel.CRITIC_EXTRA | JaxLoggingLevel.ACTOR_EXTRA
    # Perturb the params so the new/old log-likelihood ratios are not 1.
    params = jax.tree.map(lambda p: p * 1.05, params)

    def loss_fn(p):
        return jax_ppo_loss(
            p, rest, ts.network_states, rollout_data, logging_level=level,
            fused_replay=True, **LOSS_KW,
        )

    (jax_loss, jax_metrics), jax_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True)
    )(params)

    net = port_network(ts.networks)
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(1.05)
    loss, metrics = ppo_loss(
        net, net.initialize_state(N_ENVS), port_transition(rollout_data),
        logging_level=LoggingLevel.LOSSES | LoggingLevel.CRITIC_EXTRA | LoggingLevel.ACTOR_EXTRA,
        **LOSS_KW,
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_loss), rtol=1e-4, atol=1e-6)
    for key in ("losses/actor", "losses/critic", "losses/regularization", "losses/critic_R^2",
                "losses/clipping_fraction"):
        np.testing.assert_allclose(
            metrics[key].detach().numpy(), np.asarray(jax_metrics[key]), rtol=1e-4, atol=1e-6,
            err_msg=key,
        )
    np.testing.assert_allclose(
        metrics["losses/advantages"].numpy(), np.asarray(jax_metrics["losses/advantages"]),
        rtol=1e-4, atol=1e-5,
    )
    jax_grad_leaves = jax.tree.leaves(jax_grads)
    torch_grads = [p.grad.numpy() for p in net.parameters()]
    assert len(jax_grad_leaves) == len(torch_grads)
    for g_jax, g_torch in zip(jax_grad_leaves, torch_grads):
        np.testing.assert_allclose(g_torch, np.asarray(g_jax), rtol=1e-4, atol=1e-6)


def test_update_phase_matches_jax_ppo_step(jax_setup):
    """One whole update phase: the JAX ppo_step against ppo_update on the
    JAX rollout with the JAX minibatch selectors, then the Normalizer
    fold. Tolerance rtol 1e-4 / atol 2e-6 on params: 16 adam updates of
    lr 3e-4 each, whose normalized steps amplify float32 rounding of
    near-zero gradients to at most a few lr·1e-3."""
    env, config, ts, rollout_data, selectors = jax_setup
    net = port_network(ts.networks)
    jax_optimizer = jax_make_optimizer(config.learning_rate)
    new_ts, jax_metrics = jax.jit(jax_ppo_step, static_argnums=(0, 2, 3))(
        env, ts, config, jax_optimizer
    )

    optimizer = make_optimizer(3e-4)
    opt_state = optimizer.init(net.parameters())
    port_config = PPOConfig(n_envs=N_ENVS, rollout_length=T, learning_rate=3e-4)
    port_rollout = port_transition(rollout_data)
    loss_metrics = ppo_update(
        net, opt_state, net.initialize_state(N_ENVS), port_rollout, port_config, optimizer,
        selectors=torch.tensor(selectors, dtype=torch.long),
    )
    net.update_statistics(port_rollout.rollout_extras)

    np.testing.assert_allclose(
        loss_metrics["losses/actor"].mean().item(),
        float(jax_metrics["losses/actor/mean"]), rtol=1e-3, atol=1e-6,
    )
    new_params, new_rest = partition_params(new_ts.networks)
    for p_jax, p_torch in zip(jax.tree.leaves(new_params), net.parameters()):
        np.testing.assert_allclose(p_torch.detach().numpy(), np.asarray(p_jax), rtol=1e-4, atol=2e-6)
    adam_state = new_ts.opt_state[0][0]  # chain(adam) -> (ScaleByAdamState, EmptyState)
    assert int(adam_state.count) == opt_state.param_groups[0]["update_count"] == 16
    for mu, nu, p in zip(jax.tree.leaves(adam_state.mu), jax.tree.leaves(adam_state.nu), net.parameters()):
        state = opt_state.state[p]
        np.testing.assert_allclose(state["exp_avg"].numpy(), np.asarray(mu), rtol=1e-3, atol=1e-7)
        np.testing.assert_allclose(state["exp_avg_sq"].numpy(), np.asarray(nu), rtol=1e-3, atol=1e-10)
    jax_norm = new_rest.layers[0]
    np.testing.assert_allclose(net[0].mean.numpy(), np.asarray(jax_norm.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(net[0].M2.numpy(), np.asarray(jax_norm.M2), rtol=1e-5)
    assert float(net[0].counter) == float(jax_norm.counter) == N_ENVS * T


def _port_env():
    return EpisodeWrapper(CartpoleBalance(), max_len=12)


def test_ppo_multi_step_on_cpu_commits_after_updates():
    env = _port_env()
    net = make_mlp_actor_critic(5, 1, ACTOR, CRITIC, 0)
    config = PPOConfig(n_envs=N_ENVS, rollout_length=T, logging_level=LoggingLevel.ALL)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(env, net, N_ENVS, seed=1, optimizer=optimizer, device="cpu")
    before = [p.detach().clone() for p in ts.networks.parameters()]
    ts, metrics = ppo_multi_step(env, ts, config, optimizer, n_steps=2, return_history=True)
    assert ts.steps_taken == 2 * N_ENVS * T
    assert metrics["losses/actor/mean"].shape == (2,)
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values())
    assert float(ts.networks[0].counter) == 2 * N_ENVS * T
    # The caller's module is untouched; the state's copy was trained.
    for p0, p_caller, p in zip(before, net.parameters(), ts.networks.parameters()):
        assert torch.equal(p0, p_caller) and not torch.equal(p0, p)


def test_ppo_step_is_reproducible_from_the_seed():
    env = _port_env()
    config = PPOConfig(n_envs=N_ENVS, rollout_length=T)
    optimizer = make_optimizer(config.learning_rate)
    losses = []
    for _ in range(2):
        net = make_mlp_actor_critic(5, 1, ACTOR, CRITIC, 0)
        ts = new_training_state(env, net, N_ENVS, seed=7, optimizer=optimizer, device="cpu")
        _, metrics = ppo_step(env, ts, config, optimizer)
        losses.append(metrics["losses/actor/mean"].item())
    assert losses[0] == losses[1]


def test_gradient_clipping_and_adamw_run():
    env = _port_env()
    config = PPOConfig(n_envs=N_ENVS, rollout_length=T, gradient_clipping=1e-3, weight_decay=1e-2,
                       logging_level=LoggingLevel.LOSSES | LoggingLevel.GRAD_NORM)
    optimizer = make_optimizer(3e-4, config.gradient_clipping, config.weight_decay)
    ts = new_training_state(env, make_mlp_actor_critic(5, 1, ACTOR, CRITIC, 0), N_ENVS, seed=0,
                            optimizer=optimizer, device="cpu")
    assert isinstance(ts.opt_state, torch.optim.AdamW)
    _, metrics = ppo_step(env, ts, config, optimizer)
    assert float(metrics["grad_norm/mean"]) > 1e-3  # clipped only after it was measured


def test_train_ppo_cpu_smoke():
    env = _port_env()
    net = make_mlp_actor_critic(5, 1, ACTOR, CRITIC, 0)
    logged = []
    config = TrainConfig(
        ppo=PPOConfig(n_envs=N_ENVS, rollout_length=T, total_steps=4 * N_ENVS * T,
                      steps_per_call=2, anneal_lr=True,
                      logging_level=LoggingLevel.LOSSES | LoggingLevel.THROUGHPUT),
        eval=EvalConfig(every_steps=2 * N_ENVS * T, n_envs=4, max_episode_length=10),
        seed=3,
    )
    res = train_ppo(env, net, config, log_fn=lambda m, s: logged.append(s), device="cpu")
    assert res.total_steps == 4 * N_ENVS * T and res.total_iterations == 2
    assert [e["step"] for e in res.eval_history] == [0, 2 * N_ENVS * T, 4 * N_ENVS * T]
    assert all(0 <= e["lifespan_mean"] <= 10 for e in res.eval_history)
    assert logged == [0, N_ENVS * T, 2 * N_ENVS * T, 3 * N_ENVS * T, 4 * N_ENVS * T]
    assert res.final_metrics["throughput/train_sps"] > 0
    assert res.training_state.opt_state.param_groups[0]["lr"] < 3e-4 * 0.5  # annealed
    # Resume from the returned state.
    res2 = train_ppo(env, net, dataclasses.replace(config, eval=EvalConfig(enabled=False)),
                     total_steps=6 * N_ENVS * T, initial_state=res.training_state, device="cpu")
    assert res2.total_steps == 6 * N_ENVS * T


def test_video_fn_is_ignored_while_video_is_off():
    """As in JAX: a ``video_fn`` with ``config.video.enabled`` False is
    never called (and no longer refused)."""
    videos = []
    config = TrainConfig(ppo=PPOConfig(n_envs=4, rollout_length=2, total_steps=16),
                         eval=EvalConfig(enabled=False))
    res = train_ppo(_port_env(), make_mlp_actor_critic(5, 1, ACTOR, CRITIC, 0), config,
                    video_fn=videos.append, device="cpu")
    assert res.total_steps == 16 and videos == []


def test_cuda_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_training_state(_port_env(), make_mlp_actor_critic(5, 1, ACTOR, CRITIC, 0), 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ppo(_port_env(), make_mlp_actor_critic(5, 1, ACTOR, CRITIC, 0))


def test_package_imports_neither_jax_nor_the_jax_package():
    """Import every module of nnx_ppo_tpu_torch in a fresh interpreter and
    check that neither jax nor nnx_ppo_tpu was loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nnx_ppo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'nnx_ppo_tpu_torch.')]\n"
        "assert len(names) >= 20, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nnx_ppo_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


# -- dict observations and rewards: the physics leg's loss ----------------------


def _physics_rollout(jax_net, T, B, seed):
    """A JAX Transition with dict obs, dict rewards and dict values: obs,
    rewards and flags from numpy, the network's outputs from the JAX net."""
    from nnx_ppo_tpu.algorithms.types import Transition as JaxTransition

    rng = np.random.RandomState(seed)
    obs = {"proprio": rng.randn(T + 1, B, 42).astype(np.float32),
           "command": rng.randn(T + 1, B, 3).astype(np.float32)}
    state = jax_net.initialize_state(B)
    outs = []
    for step in range(T):
        out = jax_net(state, {k: jnp.asarray(v[step]) for k, v in obs.items()})
        state = out.next_state
        outs.append(out)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
    done = rng.rand(T, B) < 0.15
    return JaxTransition(
        obs={k: jnp.asarray(v[:-1]) for k, v in obs.items()},
        network_output=stacked.output,
        rewards={"tracking": jnp.asarray(rng.rand(T, B).astype(np.float32)),
                 "penalty": jnp.asarray(-0.1 * rng.rand(T, B).astype(np.float32))},
        done=jnp.asarray(done),
        truncated=jnp.asarray(done & (rng.rand(T, B) < 0.5)),
        next_obs={k: jnp.asarray(v[1:]) for k, v in obs.items()},
        metrics={},
        rollout_extras=stacked.rollout_extras,
    )


@pytest.mark.parametrize("combine", [True, False], ids=["combined_advantages", "per_key"])
def test_ppo_loss_with_dict_rewards_matches_jax(combine):
    """The physics network (Concat encoder, Parallel critic), per-key
    GAE, team-summed advantages. rtol 1e-4 / atol 1e-6, as for the
    flagship loss: float32 sums over T·B terms in another order."""
    from test_torch_networks import jax_physics_net, port_physics_net

    jax_net = jax_physics_net(seed=1)
    T_, B_ = 6, 10
    rollout_data = _physics_rollout(jax_net, T_, B_, seed=5)
    params, rest = partition_params(jax_net)
    params = jax.tree.map(lambda p: p * 1.05, params)
    kw = dict(LOSS_KW, combine_advantages=combine)
    if not combine:
        # Without combining, a dict of advantages needs a dict of
        # log-likelihoods; the physics net has one policy, so only the
        # combined form is defined for it in both packages.
        with pytest.raises(Exception):
            jax_ppo_loss(params, rest, jax_net.initialize_state(B_), rollout_data,
                         logging_level=JaxLoggingLevel.LOSSES, fused_replay=True, **kw)
        net = port_physics_net(jax_net)
        with pytest.raises(Exception):
            ppo_loss(net, net.initialize_state(B_), port_transition(rollout_data),
                     logging_level=LoggingLevel.LOSSES, **kw)
        return

    def loss_fn(p):
        return jax_ppo_loss(
            p, rest, jax_net.initialize_state(B_), rollout_data,
            logging_level=JaxLoggingLevel.LOSSES, fused_replay=True, **kw,
        )

    (jax_loss, jax_metrics), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    net = port_physics_net(jax_net)
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(1.05)
    loss, metrics = ppo_loss(
        net, net.initialize_state(B_), port_transition(rollout_data),
        logging_level=LoggingLevel.LOSSES, **kw,
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_loss), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        metrics["losses/actor"].item(), float(jax_metrics["losses/actor"]), rtol=1e-4, atol=1e-6
    )
    for key in ("tracking", "penalty"):
        np.testing.assert_allclose(
            metrics["losses/critic"][key].item(), float(jax_metrics["losses/critic"][key]),
            rtol=1e-4, atol=1e-6,
        )
    jax_grad_leaves = jax.tree.leaves(jax_grads)
    torch_grads = [p.grad.numpy() for p in net.parameters()]
    assert len(jax_grad_leaves) == len(torch_grads) == 16
    for g_jax, g_torch in zip(jax_grad_leaves, torch_grads):
        np.testing.assert_allclose(g_torch, np.asarray(g_jax), rtol=1e-4, atol=1e-6)


def test_unshuffled_minibatch_plan_matches_jax():
    """shuffle_minibatches=False: the same selectors and the same
    contiguous env blocks as the JAX plan."""
    from nnx_ppo_tpu.parallel.permutation import minibatch_plan as jax_minibatch_plan
    from nnx_ppo_tpu_torch.parallel.permutation import minibatch_plan

    n_envs, E, M = 12, 3, 4
    jax_sel, jax_take_seq, jax_take_batch = jax_minibatch_plan(n_envs, E, M, shuffle=False)
    sel, take_seq, take_batch = minibatch_plan(n_envs, E, M, shuffle=False)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jax_sel))
    x = np.random.RandomState(0).randn(5, n_envs, 3).astype(np.float32)
    for m in sel.tolist():
        np.testing.assert_array_equal(
            take_seq(torch.from_numpy(x), m).numpy(), np.asarray(jax_take_seq(jnp.asarray(x), m))
        )
        np.testing.assert_array_equal(
            take_batch(torch.from_numpy(x[0]), m).numpy(),
            np.asarray(jax_take_batch(jnp.asarray(x[0]), m)),
        )
    with pytest.raises(ValueError, match="divisible"):
        minibatch_plan(10, E, M, shuffle=False)
    with pytest.raises(ValueError, match="selectors"):
        minibatch_plan(n_envs, E, M, shuffle=False, selectors=sel)


def test_unshuffled_update_phase_uses_contiguous_blocks(jax_setup):
    """ppo_update with shuffle_minibatches=False equals ppo_update with
    the block selectors injected."""
    _, _, ts, rollout_data, _ = jax_setup
    optimizer = make_optimizer(3e-4)
    port_rollout = port_transition(rollout_data)
    results = []
    for shuffle in (False, True):
        net = port_network(ts.networks)
        config = PPOConfig(n_envs=N_ENVS, rollout_length=T, learning_rate=3e-4,
                           shuffle_minibatches=shuffle)
        k = N_ENVS // config.n_minibatches
        blocks = torch.arange(N_ENVS).reshape(config.n_minibatches, k).repeat(config.n_epochs, 1)
        ppo_update(
            net, optimizer.init(net.parameters()), net.initialize_state(N_ENVS), port_rollout,
            config, optimizer, selectors=blocks if shuffle else None,
        )
        results.append([p.detach().clone() for p in net.parameters()])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
