"""The batch-major replay layout and the bf16 replay store of
nnx_ppo_tpu_torch against nnx_ppo_tpu's (``PPOConfig.rollout_layout``,
``PPOConfig.replay_store_dtype``; mirrors ``tests/test_replay_layout.py``).

The JAX package makes the rollouts (its draws cannot be reproduced by a
torch.Generator); rollout, carries and weights are carried across as
numpy. Tolerance: float32 rtol 1e-5 / atol 1e-6 (the same sums reduced in
another order), unless a test says why otherwise; selections and dtype
casts are held to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_networks import carried_across, jax_physics_net, port_physics_net
from test_torch_ppo import _physics_rollout, port_transition
from test_torch_sequence_replay import gru_net, jax_gru_net

from nnx_ppo_tpu.algorithms import DistillationConfig as JaxDistillationConfig
from nnx_ppo_tpu.algorithms import PPOConfig as JaxPPOConfig
from nnx_ppo_tpu.algorithms import make_optimizer as jax_make_optimizer
from nnx_ppo_tpu.algorithms import new_training_state as jax_new_training_state
from nnx_ppo_tpu.algorithms import rollout as jax_rollout
from nnx_ppo_tpu.algorithms.ppo import ReplayMinibatch as JaxReplayMinibatch
from nnx_ppo_tpu.algorithms.ppo import ppo_loss as jax_ppo_loss
from nnx_ppo_tpu.algorithms.ppo import ppo_step as jax_ppo_step
from nnx_ppo_tpu.algorithms.ppo import resolve_batch_major as jax_resolve_batch_major
from nnx_ppo_tpu.algorithms.ppo import resolve_store_dtype as jax_resolve_store_dtype
from nnx_ppo_tpu.algorithms.types import LoggingLevel as JaxLoggingLevel
from nnx_ppo_tpu.core.struct import partition_params
from nnx_ppo_tpu.envs import CartpoleBalance as JaxCartpoleBalance
from nnx_ppo_tpu.networks import Flattener as JaxFlattener
from nnx_ppo_tpu.networks import Sequential as JaxSequential
from nnx_ppo_tpu.networks import make_mlp_actor_critic as jax_make_mlp_actor_critic
from nnx_ppo_tpu.networks.types import replay_sequence_nd as jax_replay_sequence_nd
from nnx_ppo_tpu.parallel.permutation import minibatch_permutations
from nnx_ppo_tpu.parallel.permutation import minibatch_plan as jax_minibatch_plan
from nnx_ppo_tpu.wrappers import EpisodeWrapper as JaxEpisodeWrapper
from nnx_ppo_tpu_torch.algorithms import (
    DistillationConfig,
    LoggingLevel,
    PPOConfig,
    Transition,
    make_optimizer,
    new_training_state,
    ppo_loss,
    ppo_multi_step,
    ppo_update,
    resolve_batch_major,
    resolve_store_dtype,
)
from nnx_ppo_tpu_torch.algorithms.ppo import ReplayMinibatch
from nnx_ppo_tpu_torch.convert import to_torch
from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_map, tree_stack
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import Flattener, PPONetworkOutput, Sequential, make_mlp_actor_critic
from nnx_ppo_tpu_torch.networks.types import replay_sequence_nd
from nnx_ppo_tpu_torch.parallel.permutation import minibatch_plan
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

N_ENVS, T = 8, 5
ACTOR, CRITIC = [16, 16], [16]
TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_KW = dict(
    clip_range=0.2,
    normalize_advantages=True,
    discounting_factor=0.99,
    gae_lambda=0.95,
    critic_loss_weight=1.0,
)
LEVEL = JaxLoggingLevel.LOSSES | JaxLoggingLevel.CRITIC_EXTRA
PORT_LEVEL = LoggingLevel.LOSSES | LoggingLevel.CRITIC_EXTRA


def jax_mlp(seed=0, **kw):
    return jax_make_mlp_actor_critic(5, 1, ACTOR, CRITIC, jax.random.key(seed),
                                     entropy_weight=1e-3, **kw)


def port_mlp(jax_net=None, **kw):
    net = make_mlp_actor_critic(5, 1, ACTOR, CRITIC, 0, entropy_weight=1e-3, **kw)
    return net if jax_net is None else carried_across(jax_net, net)


@pytest.fixture(scope="module")
def jax_setup():
    """A JAX flagship-shaped training state (8 envs, T=5, a 4-step time
    limit: resets and truncations inside T), the rollout its first
    ppo_step makes, and that step's minibatch selectors."""
    env = JaxEpisodeWrapper(JaxCartpoleBalance(), max_len=4)
    net = jax_mlp(normalize_obs=True)
    config = JaxPPOConfig(n_envs=N_ENVS, rollout_length=T, learning_rate=3e-4, n_epochs=2,
                          n_minibatches=2, rollout_layout="batch_major")
    ts = jax_new_training_state(env, net, N_ENVS, seed=3, learning_rate=3e-4)
    reset_key, perm_key, _ = jax.random.split(ts.rng_key, 3)
    _, _, rollout_data = jax.jit(jax_rollout.unroll_env, static_argnums=(0, 4))(
        env, ts.env_states, ts.networks, ts.network_states, T, reset_key
    )
    selectors = minibatch_permutations(perm_key, N_ENVS, config.n_epochs, config.n_minibatches)
    return env, config, ts, rollout_data, np.asarray(selectors)


def test_rollout_has_terminals_and_truncations(jax_setup):
    _, _, _, rollout_data, _ = jax_setup
    assert bool(rollout_data.done.any()) and bool(rollout_data.truncated.any())


# -- the resolver ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["static_mlp", "gru", "mlp_fused_replay_off"])
def test_auto_layout_resolves_as_jax(case):
    """"auto" is batch-major exactly where JAX's resolve_batch_major says
    so: a static MLP actor-critic under fused_replay; never a GRU net, nor
    any net with fused_replay=False. (The port resolved every "auto" to
    time-major before.)"""
    jax_net, net = (jax_gru_net(), gru_net()) if case == "gru" else (jax_mlp(), port_mlp())
    fused = case != "mlp_fused_replay_off"
    want = jax_resolve_batch_major(JaxPPOConfig(fused_replay=fused), jax_net)
    assert want == (case == "static_mlp")
    assert resolve_batch_major(PPOConfig(fused_replay=fused), net) is want
    assert resolve_batch_major(DistillationConfig(fused_replay=fused), net) is want
    assert resolve_batch_major(PPOConfig(rollout_layout="time_major"), net) is False


@pytest.mark.parametrize("kind", ["ppo", "distillation"])
def test_unknown_layout_and_store_dtype_raise_jaxs_errors(kind):
    """JAX's ValueErrors, word for word: batch-major on a recurrent net, an
    unknown layout, an unknown store dtype. The known store dtypes resolve
    to None (float32) and bfloat16."""
    jax_cls, cls = ((JaxPPOConfig, PPOConfig) if kind == "ppo"
                    else (JaxDistillationConfig, DistillationConfig))
    cases = [
        (dict(rollout_layout="batch_major"), jax_gru_net(), gru_net()),
        (dict(rollout_layout="colmajor"), jax_mlp(), port_mlp()),
    ]
    for kw, jax_net, net in cases:
        with pytest.raises(ValueError) as want:
            jax_resolve_batch_major(jax_cls(**kw), jax_net)
        with pytest.raises(ValueError) as got:
            resolve_batch_major(cls(**kw), net)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_resolve_store_dtype(jax_cls(replay_store_dtype="float8"))
    with pytest.raises(ValueError, match="replay_store_dtype") as got:
        resolve_store_dtype(cls(replay_store_dtype="float8"))
    assert str(got.value) == str(want.value)
    assert resolve_store_dtype(cls()) is None
    assert resolve_store_dtype(cls(replay_store_dtype="bfloat16")) is torch.bfloat16


# -- minibatch membership ---------------------------------------------------------


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "contiguous"])
def test_minibatch_membership_is_the_same_in_both_layouts(shuffle):
    """take_seq selects the same (env, step) samples as JAX's plan in both
    layouts (shuffled with JAX's selectors injected), and the batch-major
    minibatch is the time-major one transposed: to the bit."""
    n_envs, E, M = 16, 2, 4
    key = jax.random.key(3)
    x_tm = np.arange(T * n_envs * 3, dtype=np.float32).reshape(T, n_envs, 3)
    x_bm = np.swapaxes(x_tm, 0, 1).copy()
    taken = {}
    for batch_major, x in ((False, x_tm), (True, x_bm)):
        jax_sel, jax_take_seq, jax_take_batch = jax_minibatch_plan(
            n_envs, E, M, shuffle=shuffle, key=key if shuffle else None, batch_major=batch_major)
        kw = dict(selectors=torch.tensor(np.asarray(jax_sel), dtype=torch.long)) if shuffle else {}
        sel, take_seq, take_batch = minibatch_plan(n_envs, E, M, shuffle=shuffle,
                                                   batch_major=batch_major, **kw)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jax_sel))
        taken[batch_major] = []
        for s, s_jax in zip(sel, jax_sel):
            s = s if shuffle else int(s)
            got = take_seq(torch.from_numpy(x), s).numpy()
            np.testing.assert_array_equal(got, np.asarray(jax_take_seq(jnp.asarray(x), s_jax)))
            np.testing.assert_array_equal(
                take_batch(torch.from_numpy(x_bm[:, 0]), s).numpy(),
                np.asarray(jax_take_batch(jnp.asarray(x_bm[:, 0]), s_jax)))
            taken[batch_major].append(got)
    for a, b in zip(taken[False], taken[True]):
        np.testing.assert_array_equal(a, np.swapaxes(b, 0, 1))


# -- replay_sequence_nd --------------------------------------------------------------


def bt(x):
    return np.swapaxes(np.asarray(x), 0, 1)


def jax_bt(x):
    return jnp.swapaxes(x, 0, 1)


def test_replay_sequence_nd_matches_jax_and_the_time_major_replay(jax_setup):
    """One forward over [B, T] leading dims: JAX's replay_sequence_nd on
    the same obs and extras, and the port's time-major fused replay
    transposed (rtol 1e-5 / atol 1e-6). The carry comes back as given."""
    _, _, ts, rollout_data, _ = jax_setup
    jax_out, jax_reg, _ = jax_replay_sequence_nd(
        ts.networks, ts.network_states, jax.tree.map(jax_bt, rollout_data.obs), T,
        jax.tree.map(jax_bt, rollout_data.rollout_extras))
    net = port_mlp(ts.networks)
    state = net.initialize_state(N_ENVS)
    tr = port_transition(rollout_data)
    with torch.no_grad():
        out, reg, final = replay_sequence_nd(
            net, state, tr.obs.transpose(0, 1), T,
            tree_map(lambda x: x.transpose(0, 1), tr.rollout_extras))
        out_tm, reg_tm, _ = net.replay_sequence(state, tr.obs, tr.done, tr.rollout_extras)
    assert final is state
    for name in ("actions", "loglikelihoods", "value_estimates"):
        got = getattr(out, name)
        assert got.shape[:2] == (N_ENVS, T)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jax_out, name)), **TOL)
        np.testing.assert_allclose(got.numpy(), bt(getattr(out_tm, name)), **TOL)
    np.testing.assert_allclose(torch.as_tensor(reg).mean().item(),
                               float(np.asarray(jax_reg).mean()), **TOL)
    np.testing.assert_allclose(torch.as_tensor(reg).mean().item(),
                               torch.as_tensor(reg_tm).mean().item(), **TOL)


def test_replay_sequence_nd_rejects_recurrent_nets():
    """JAX's ValueError, word for word, for a GRU net."""
    jax_net, net = jax_gru_net(), gru_net()
    with pytest.raises(ValueError) as want:
        jax_replay_sequence_nd(jax_net, jax_net.initialize_state(4), jnp.zeros((4, 3, 5)), 3, None)
    with pytest.raises(ValueError, match="replay-time-static") as got:
        replay_sequence_nd(net, net.initialize_state(4), torch.zeros(4, 3, 5), 3, None)
    assert str(got.value) == str(want.value)


# -- the view ------------------------------------------------------------------------


@pytest.mark.parametrize("batch_major", [False, True], ids=["time_major", "batch_major"])
def test_view_stores_only_float_obs_leaves_in_bf16(batch_major):
    """replay_store_dtype touches the float obs leaves and last_next_obs
    only: an int obs leaf, log-likelihoods, rewards, extras and flags keep
    their dtype and bits, as JAX's view keeps them; the bf16 leaves are
    JAX's bf16 rounding, to the bit."""
    rng = np.random.RandomState(0)
    Tn, Bn = 3, 4
    obs = {"x": rng.randn(Tn, Bn, 2).astype(np.float32),
           "idx": rng.randint(0, 9, (Tn, Bn)).astype(np.int32)}
    next_obs = {"x": rng.randn(Tn, Bn, 2).astype(np.float32), "idx": obs["idx"] + 1}
    arrays = dict(ll=rng.randn(Tn, Bn).astype(np.float32), rew=rng.randn(Tn, Bn).astype(np.float32),
                  extra=rng.randn(Tn, Bn, 2).astype(np.float32), done=rng.rand(Tn, Bn) < 0.3)
    tr = Transition(
        obs=to_torch(obs),
        network_output=PPONetworkOutput(torch.zeros(Tn, Bn, 1), torch.from_numpy(arrays["ll"]),
                                        torch.zeros(Tn, Bn)),
        rewards=torch.from_numpy(arrays["rew"]), done=torch.from_numpy(arrays["done"]),
        truncated=torch.from_numpy(arrays["done"]), next_obs=to_torch(next_obs), metrics={},
        rollout_extras={"e": torch.from_numpy(arrays["extra"])},
    )
    view = ReplayMinibatch.from_rollout(tr, batch_major, torch.bfloat16)
    jax_view = JaxReplayMinibatch.from_rollout(_jax_transition(obs, next_obs, arrays),
                                               batch_major, store_dtype=jnp.bfloat16)
    assert view.batch_major is batch_major
    assert view.obs["x"].dtype == view.last_next_obs["x"].dtype == torch.bfloat16
    assert view.obs["idx"].dtype == view.last_next_obs["idx"].dtype == torch.int32
    assert view.old_loglikelihoods.dtype == view.rewards.dtype == torch.float32
    assert view.rollout_extras["e"].dtype == torch.float32 and view.done.dtype == torch.bool
    pairs = [(view.obs["x"].float(), jax_view.obs["x"].astype(jnp.float32)),
             (view.obs["idx"], jax_view.obs["idx"]),
             (view.last_next_obs["x"].float(), jax_view.last_next_obs["x"].astype(jnp.float32)),
             (view.old_loglikelihoods, jax_view.old_loglikelihoods),
             (view.rewards, jax_view.rewards), (view.done, jax_view.done),
             (view.rollout_extras["e"], jax_view.rollout_extras["e"])]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if batch_major:
        assert all(x.is_contiguous() for x in tree_leaves(view.obs))


def _jax_transition(obs, next_obs, arrays):
    from nnx_ppo_tpu.algorithms.types import PPONetworkOutput as JaxOutput
    from nnx_ppo_tpu.algorithms.types import Transition as JaxTransition

    return JaxTransition(
        obs=jax.tree.map(jnp.asarray, obs),
        network_output=JaxOutput(actions=jnp.zeros(arrays["ll"].shape + (1,)),
                                 loglikelihoods=jnp.asarray(arrays["ll"]),
                                 value_estimates=jnp.zeros(arrays["ll"].shape)),
        rewards=jnp.asarray(arrays["rew"]), done=jnp.asarray(arrays["done"]),
        truncated=jnp.asarray(arrays["done"]), next_obs=jax.tree.map(jnp.asarray, next_obs),
        metrics={}, rollout_extras={"e": jnp.asarray(arrays["extra"])},
    )


# -- the batch-major loss and update ------------------------------------------------------


def _loss_pair(jax_net, net, rollout_data, state_jax, state, store, combine):
    """JAX's batch-major ppo_loss (value and gradients) and the port's, on
    the same rollout and weights (params x 1.05, so ratios are not 1)."""
    store_dtype = None if store == "float32" else jnp.bfloat16
    view = JaxReplayMinibatch.from_rollout(rollout_data, True, store_dtype=store_dtype)
    params, rest = partition_params(jax_net)
    params = jax.tree.map(lambda p: p * 1.05, params)
    kw = dict(LOSS_KW, combine_advantages=combine)

    def loss_fn(p):
        return jax_ppo_loss(p, rest, state_jax, view, logging_level=LEVEL, fused_replay=True, **kw)

    (jax_loss, jax_metrics), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(1.05)
    port_view = ReplayMinibatch.from_rollout(port_transition(rollout_data), True,
                                             resolve_store_dtype(PPOConfig(replay_store_dtype=store)))
    loss, metrics = ppo_loss(net, state, port_view, logging_level=PORT_LEVEL, **kw)
    loss.backward()
    return (jax_loss, jax_metrics, jax.tree.leaves(jax_grads)), (
        loss, metrics, [p.grad for p in net.parameters()])


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("net_kind", ["flagship_mlp", "dict_obs_concat"])
def test_batch_major_ppo_loss_and_gradients_match_jax(jax_setup, net_kind, store):
    """The batch-major loss (GAE of [b, T] keys, in place) and its
    gradients against JAX's batch-major ppo_loss, with each store dtype:
    the flagship MLP on the JAX cartpole rollout, and the physics net
    (dict obs, Concat, two reward keys, combined advantages) at B=8, T=5.
    rtol 1e-5 / atol 1e-6 on the loss and metrics; gradients rtol 1e-4 /
    atol 1e-6: sums of T·B products whose float32 rounding, reduced in
    another order, reaches 2e-5 of an entry (the bf16 store rounds the
    obs identically on both sides)."""
    if net_kind == "flagship_mlp":
        _, _, ts, rollout_data, _ = jax_setup
        jax_net, state_jax = ts.networks, ts.network_states
        net = port_mlp(jax_net)
        combine = False
    else:
        jax_net = jax_physics_net(seed=1)
        rollout_data = _physics_rollout(jax_net, T, N_ENVS, seed=5)
        state_jax = jax_net.initialize_state(N_ENVS)
        net = port_physics_net(jax_net)
        combine = True
    (jax_loss, jax_metrics, jax_grads), (loss, metrics, grads) = _loss_pair(
        jax_net, net, rollout_data, state_jax, net.initialize_state(N_ENVS), store, combine)
    np.testing.assert_allclose(loss.item(), float(jax_loss), **TOL)
    for key in ("losses/actor", "losses/critic", "losses/critic_R^2"):
        for got, want in zip(tree_leaves(metrics[key]), jax.tree.leaves(jax_metrics[key])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL, err_msg=key)
    assert len(grads) == len(jax_grads)
    for got, want in zip(grads, jax_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_batch_major_update_phase_matches_jax_ppo_step(jax_setup):
    """One whole update phase, batch-major on both sides: JAX's ppo_step
    against ppo_update on the JAX rollout with JAX's selectors, then the
    Normalizer fold. rtol 1e-4 / atol 2e-6 on params, as for the
    time-major phase (test_torch_ppo.py): 4 adam steps of lr 3e-4, whose
    normalized updates amplify the float32 rounding of near-zero
    gradients."""
    env, config, ts, rollout_data, selectors = jax_setup
    new_ts, jax_metrics = jax.jit(jax_ppo_step, static_argnums=(0, 2, 3))(
        env, ts, config, jax_make_optimizer(config.learning_rate))
    net = port_mlp(ts.networks)
    port_config = PPOConfig(n_envs=N_ENVS, rollout_length=T, learning_rate=3e-4, n_epochs=2,
                            n_minibatches=2, rollout_layout="batch_major")
    assert resolve_batch_major(port_config, net)
    optimizer = make_optimizer(3e-4)
    opt_state = optimizer.init(net.parameters())
    port_rollout = port_transition(rollout_data)
    loss_metrics = ppo_update(net, opt_state, net.initialize_state(N_ENVS), port_rollout,
                              port_config, optimizer,
                              selectors=torch.tensor(selectors, dtype=torch.long))
    net.update_statistics(port_rollout.rollout_extras)
    np.testing.assert_allclose(loss_metrics["losses/actor"].mean().item(),
                               float(jax_metrics["losses/actor/mean"]), rtol=1e-4, atol=1e-6)
    new_params, new_rest = partition_params(new_ts.networks)
    for p_jax, p in zip(jax.tree.leaves(new_params), net.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_jax), rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(net[0].mean.numpy(), np.asarray(new_rest.layers[0].mean), **TOL)


# -- the bf16 store --------------------------------------------------------------------------


def _port_rollout(net, obs_tb, seed):
    """A port Transition on seeded numpy obs (a tensor or a dict of
    [T+1, B, ...]): the network's forward per step with a generator,
    rewards and flags from numpy."""
    rng = np.random.RandomState(seed)
    obs = to_torch(obs_tb)
    Tn, Bn = tree_leaves(obs)[0].shape[:2]
    Tn -= 1
    g = torch.Generator().manual_seed(seed)
    state, outs = net.initialize_state(Bn), []
    with torch.no_grad():
        for t in range(Tn):
            out = net(state, tree_map(lambda x: x[t], obs), None, g)
            state = out.next_state
            outs.append(out)
    done = torch.from_numpy(rng.rand(Tn, Bn) < 0.2)
    return Transition(
        obs=tree_map(lambda x: x[:-1], obs),
        network_output=tree_stack([o.output for o in outs]),
        rewards=torch.from_numpy(rng.randn(Tn, Bn).astype(np.float32)),
        done=done, truncated=done & torch.from_numpy(rng.rand(Tn, Bn) < 0.5),
        next_obs=tree_map(lambda x: x[1:], obs), metrics={},
        rollout_extras=tree_stack([o.rollout_extras for o in outs]),
    )


@pytest.mark.parametrize("batch_major", [True, False], ids=["batch_major", "time_major"])
def test_bf16_store_is_exact_for_a_bf16_compute_stack(batch_major):
    """A bf16-compute MLP without obs normalization rounds its obs to
    bf16 at its first layer, so the bf16 store is the same rounding: the
    loss and every gradient torch.equal to the float32 store's; and two
    ppo_steps from one seed give the same parameters, to the bit."""
    obs = np.random.RandomState(1).randn(T + 1, N_ENVS, 5).astype(np.float32) * 3
    net = port_mlp(normalize_obs=False, compute_dtype=torch.bfloat16)
    rollout_data = _port_rollout(net, obs, seed=2)
    results = []
    for store in (None, torch.bfloat16):
        net.zero_grad(set_to_none=True)
        view = ReplayMinibatch.from_rollout(rollout_data, batch_major, store)
        loss, _ = ppo_loss(net, net.initialize_state(N_ENVS), view, logging_level=PORT_LEVEL,
                           combine_advantages=False, **LOSS_KW)
        loss.backward()
        results.append((loss, [p.grad.clone() for p in net.parameters()]))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))

    env = EpisodeWrapper(CartpoleBalance(), max_len=10)
    params = []
    for store in ("float32", "bfloat16"):
        config = PPOConfig(n_envs=N_ENVS, rollout_length=T, n_epochs=2, n_minibatches=2,
                           replay_store_dtype=store,
                           rollout_layout="batch_major" if batch_major else "time_major")
        optimizer = make_optimizer(config.learning_rate)
        ts = new_training_state(env, net, N_ENVS, seed=0, optimizer=optimizer, device="cpu")
        ts, _ = ppo_multi_step(env, ts, config, optimizer, 2)
        params.append([p.detach() for p in ts.networks.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*params))


def test_bf16_store_tracks_float32_training_on_a_float32_net():
    """On a float32 net the bf16 store is a rounding of the replayed obs
    (about three decimal digits): three ppo_steps from one seed, on JAX's
    own set-up for it (tests/test_replay_layout.py: MLP 16 / 16, no obs
    normalization), stay within JAX's tolerance for it (rtol 0.05, atol
    5e-4) and are not equal."""
    env = EpisodeWrapper(CartpoleBalance(), max_len=10)
    params = []
    for store in ("float32", "bfloat16"):
        config = PPOConfig(n_envs=N_ENVS, rollout_length=T, n_epochs=2, n_minibatches=2,
                           replay_store_dtype=store)
        optimizer = make_optimizer(config.learning_rate)
        net = make_mlp_actor_critic(5, 1, [16], [16], 0, normalize_obs=False)
        ts = new_training_state(env, net, N_ENVS, seed=0, optimizer=optimizer, device="cpu")
        ts, metrics = ppo_multi_step(env, ts, config, optimizer, 3)
        assert all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values())
        params.append([p.detach() for p in ts.networks.parameters()])
    for a, b in zip(*params):
        torch.testing.assert_close(a, b, rtol=0.05, atol=5e-4)
    assert not all(torch.equal(a, b) for a, b in zip(*params))


# -- the Flattener departure ----------------------------------------------------------------


def test_flattener_net_trains_batch_major_where_jax_raises():
    """Sequential([Flattener, MLP actor-critic]) is replay-time-static, so
    "auto" is batch-major in both packages. JAX's replay_sequence_nd
    folds T into the features (nnx_ppo_tpu/networks/utils.py:49-54) and
    raises on dict obs; the port flattens below both leading dims, and its
    batch-major loss and gradients equal its time-major ones (rtol 1e-5 /
    atol 1e-6 on the loss, rtol 1e-4 on gradients: float32 sums in
    another order)."""
    jax_net = JaxSequential.create([JaxFlattener.create(), jax_mlp()])
    assert jax_resolve_batch_major(JaxPPOConfig(), jax_net)
    dict_obs = {"a": jnp.zeros((4, 3, 2)), "b": jnp.zeros((4, 3, 3))}
    step = jax_net(jax_net.initialize_state(4), jax.tree.map(lambda x: x[:, 0], dict_obs))
    extras = jax.tree.map(lambda x: jnp.broadcast_to(x[:, None], (4, 3) + x.shape[1:]),
                          step.rollout_extras)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jax_replay_sequence_nd(jax_net, jax_net.initialize_state(4), dict_obs, 3, extras)

    net = Sequential.create([Flattener.create(), port_mlp()])
    assert resolve_batch_major(PPOConfig(), net)
    rng = np.random.RandomState(4)
    obs = {"a": rng.randn(T + 1, N_ENVS, 2).astype(np.float32),
           "b": rng.randn(T + 1, N_ENVS, 3).astype(np.float32)}
    rollout_data = _port_rollout(net, obs, seed=5)
    results = []
    for batch_major in (True, False):
        net.zero_grad(set_to_none=True)
        loss, _ = ppo_loss(net, net.initialize_state(N_ENVS),
                           ReplayMinibatch.from_rollout(rollout_data, batch_major),
                           logging_level=PORT_LEVEL, combine_advantages=False, **LOSS_KW)
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in net.parameters()]))
    (loss_bm, grads_bm), (loss_tm, grads_tm) = results
    np.testing.assert_allclose(loss_bm, loss_tm, **TOL)
    for a, b in zip(grads_bm, grads_tm):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
