"""Layer and env parity: each flagship module of nnx_ppo_tpu_torch against
its JAX counterpart, on the same numpy inputs, with the JAX weights and
Normalizer statistics carried across by nnx_ppo_tpu_torch.convert.

Tolerance: rtol = 1e-5, atol = 1e-6 in float32 unless a test says
otherwise. Both sides compute the same float32 arithmetic; they differ
only in reduction order inside matmuls and sums (the JAX suite runs its
matmuls at 'highest' precision, tests/conftest.py), a few ulps per op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.core.struct import partition_params
from nnx_ppo_tpu.envs import CartpoleBalance as JaxCartpoleBalance
from nnx_ppo_tpu.networks import make_mlp_actor_critic as jax_make_mlp_actor_critic
from nnx_ppo_tpu.networks.feedforward import Dense as JaxDense
from nnx_ppo_tpu.networks.normalizer import Normalizer as JaxNormalizer
from nnx_ppo_tpu.networks.sampling_layers import NormalTanhSampler as JaxSampler
from nnx_ppo_tpu.wrappers import EpisodeWrapper as JaxEpisodeWrapper
from nnx_ppo_tpu_torch.convert import load_jax_leaves, to_torch
from nnx_ppo_tpu_torch.envs import CartpoleBalance, State
from nnx_ppo_tpu_torch.networks import (
    Concat,
    Dense,
    Normalizer,
    NormalTanhSampler,
    Parallel,
    PPOAdapter,
    Sequential,
    make_mlp,
    make_mlp_actor_critic,
)
from nnx_ppo_tpu_torch.networks.sampling_layers import softplus
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def np_leaves(tree):
    """JAX tree -> the same tree with numpy leaves; PRNG keys -> None."""
    return jax.tree.map(
        lambda x: None if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else np.asarray(x),
        tree,
    )


def carried_across(jax_net, torch_net):
    """Load the JAX params and the non-param leaves (Normalizer stats)."""
    params, rest = partition_params(jax_net)
    load_jax_leaves(torch_net, np_leaves(params))
    load_jax_leaves(torch_net, np_leaves(rest))
    return torch_net


def test_dense_forward():
    rng = np.random.RandomState(0)
    jax_dense = JaxDense.create(
        6, 4, jax.random.key(1), activation=jax.nn.relu,
        kernel_init=jax.nn.initializers.normal(1.0),
    )
    jax_dense = jax_dense.replace(bias=jnp.asarray(rng.randn(4).astype(np.float32)))
    dense = carried_across(jax_dense, Dense.create(6, 4, torch.Generator(), torch.relu))
    x = rng.randn(3, 5, 6).astype(np.float32)  # [T, B, in]: leading dims batch
    want = np.asarray(jax_dense((), jnp.asarray(x)).output)
    got = dense((), torch.from_numpy(x)).output.detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_dense_init_is_variance_scaling_fan_in_uniform():
    dense = Dense.create(64, 256, torch.Generator().manual_seed(0))
    limit = np.sqrt(3.0 / 64)
    w = dense.kernel.detach().numpy()
    assert w.shape == (64, 256) and np.abs(w).max() <= limit
    # U(-l, l) has std l / sqrt(3); 16k samples pin it to ~1%.
    np.testing.assert_allclose(w.std(), limit / np.sqrt(3.0), rtol=0.03)
    assert not dense.bias.detach().any()


def test_normalizer_warmup_and_fold():
    rng = np.random.RandomState(1)
    jax_norm = JaxNormalizer.create(5)
    norm = Normalizer.create(5)
    x = (3.0 + 2.0 * rng.randn(4, 5)).astype(np.float32)
    # Before the first fold: mean 0, std 10.
    out = norm((), torch.from_numpy(x))
    np.testing.assert_allclose(out.output.numpy(), x / 10.0, **TOL)
    assert out.rollout_extras is not None  # raw input emitted for the fold
    for step in range(2):
        history = (1.0 + step + 3.0 * rng.randn(6, 4, 5)).astype(np.float32)
        jax_norm = jax_norm.update_statistics(jnp.asarray(history))
        norm.update_statistics(torch.from_numpy(history))
        np.testing.assert_allclose(norm.mean.numpy(), np.asarray(jax_norm.mean), **TOL)
        np.testing.assert_allclose(norm.M2.numpy(), np.asarray(jax_norm.M2), rtol=1e-5)
        assert float(norm.counter) == float(jax_norm.counter) == 24.0 * (step + 1)
        want = np.asarray(jax_norm((), jnp.asarray(x)).output)
        np.testing.assert_allclose(norm((), torch.from_numpy(x)).output.numpy(), want, **TOL)


def test_normalizer_epsilon_floors_the_variance():
    norm = Normalizer.create(2, epsilon=1e-4)
    norm.update_statistics(torch.ones(3, 4, 2))  # zero variance
    std = norm._std()
    np.testing.assert_allclose(std.numpy(), np.sqrt(1e-4), rtol=1e-6)


def test_softplus_matches_jax_beyond_torch_threshold():
    x = np.array([-80.0, -5.0, 0.0, 5.0, 19.0, 21.0, 35.0, 80.0], np.float32)
    np.testing.assert_allclose(
        softplus(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.softplus(x)), **TOL
    )


def test_normal_tanh_sampler_replay_with_extras():
    rng = np.random.RandomState(2)
    B, A = 6, 3
    mean_and_std = (2.0 * rng.randn(B, 2 * A)).astype(np.float32)
    mean_and_std[0, A:] = 25.0  # raw std past torch's softplus threshold
    extras = {
        "raw_action": rng.randn(B, A).astype(np.float32),
        "entropy_noise": rng.randn(B, A).astype(np.float32),
    }
    jax_sampler = JaxSampler.create(jax.random.key(0), entropy_weight=0.01, min_std=0.1)
    sampler = NormalTanhSampler.create(entropy_weight=0.01, min_std=0.1)
    jax_out = jax_sampler(
        jax_sampler.initialize_state(B),
        jnp.asarray(mean_and_std),
        jax.tree.map(jnp.asarray, extras),
    )
    out = sampler((), torch.from_numpy(mean_and_std), to_torch(extras))
    for key in ("action", "log_likelihood"):
        np.testing.assert_allclose(
            out.output[key].numpy(), np.asarray(jax_out.output[key]), rtol=1e-5, atol=1e-5
        )
    np.testing.assert_allclose(
        out.regularization_loss.numpy(), np.asarray(jax_out.regularization_loss), **TOL
    )
    np.testing.assert_array_equal(out.rollout_extras["raw_action"].numpy(), extras["raw_action"])


def test_sampler_draws_from_the_generator_and_eval_emits_the_mean():
    sampler = NormalTanhSampler.create()
    x = torch.randn(4, 2, generator=torch.Generator().manual_seed(0))
    a = sampler((), x, None, torch.Generator().manual_seed(5)).rollout_extras
    b = sampler((), x, None, torch.Generator().manual_seed(5)).rollout_extras
    c = sampler((), x, None, torch.Generator().manual_seed(6)).rollout_extras
    torch.testing.assert_close(a, b)
    assert not torch.equal(a["raw_action"], c["raw_action"])
    sampler.eval()
    mean = sampler((), x, None, torch.Generator().manual_seed(5)).rollout_extras["raw_action"]
    torch.testing.assert_close(mean, x[:, :1])


def _flagship_pair(seed=0, actor=(16, 16), critic=(32,)):
    """A small JAX actor-critic with folded Normalizer stats, and its port."""
    jax_net = jax_make_mlp_actor_critic(
        5, 1, list(actor), list(critic), jax.random.key(seed),
        normalize_obs=True, entropy_weight=1e-3,
    )
    obs_history = np.random.RandomState(seed).randn(4, 8, 5).astype(np.float32) * 2 + 0.5
    jax_net = jax_net.update_statistics(
        (jnp.asarray(obs_history), {"action": (None,) * (len(actor) + 2), "value": (None,) * (len(critic) + 1)})
    )
    net = make_mlp_actor_critic(5, 1, list(actor), list(critic), seed, entropy_weight=1e-3)
    return jax_net, carried_across(jax_net, net)


def test_mlp_actor_critic_structure_and_weights():
    jax_net, net = _flagship_pair()
    jax_params = jax.tree.leaves(partition_params(jax_net)[0])
    torch_params = [p.detach().numpy() for p in net.parameters()]
    assert len(jax_params) == len(torch_params) == 10  # actor 3 + critic 2 Dense
    for a, b in zip(jax_params, torch_params):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert float(net[0].counter) == 32.0
    assert net.replay_time_static


def test_mlp_actor_critic_forward_and_replay():
    """The whole network: the JAX rollout forward draws its noise; the
    port replays with those extras (single step and fused [T, B])."""
    jax_net, net = _flagship_pair()
    T, B = 3, 8
    obs = np.random.RandomState(3).randn(T, B, 5).astype(np.float32)
    jax_state = jax_net.initialize_state(B)
    jax_outs = []
    for t in range(T):
        out = jax_net(jax_state, jnp.asarray(obs[t]))
        jax_state = out.next_state
        jax_outs.append(out)
    jax_seq = jax.tree.map(lambda *xs: np.stack(xs), *[np_leaves(o) for o in jax_outs])

    # One step, extras given.
    out0 = net(net.initialize_state(B), torch.from_numpy(obs[0]), to_torch(np_leaves(jax_outs[0].rollout_extras)))
    want0 = jax_outs[0].output
    for got, want in (
        (out0.output.actions, want0.actions),
        (out0.output.loglikelihoods, want0.loglikelihoods),
        (out0.output.value_estimates, want0.value_estimates),
        (out0.regularization_loss, jax_outs[0].regularization_loss),
    ):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    # Fused replay over [T, B].
    done = torch.zeros(T, B, dtype=torch.bool)
    output, reg, final = net.replay_sequence(
        net.initialize_state(B), torch.from_numpy(obs), done, to_torch(jax_seq.rollout_extras)
    )
    assert final == net.initialize_state(B)
    np.testing.assert_allclose(
        output.loglikelihoods.detach().numpy(), jax_seq.output.loglikelihoods, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        output.value_estimates.detach().numpy(), jax_seq.output.value_estimates, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(reg.detach().numpy(), jax_seq.regularization_loss, rtol=1e-5, atol=1e-6)
    assert output.value_estimates.shape == (T, B)  # trailing 1 squeezed


def _jax_env_states(env, q, step_counter):
    keys = jax.random.split(jax.random.key(0), q.shape[0])
    states = jax.vmap(env.reset)(keys)
    info = dict(states.info)
    info["step_counter"] = jnp.asarray(step_counter)
    data = {"q": jnp.asarray(q)}
    return states.replace(data=data, info=info)


def test_cartpole_episode_wrapper_step_parity():
    rng = np.random.RandomState(4)
    B, max_len = 12, 20
    q = (0.3 * rng.randn(B, 4)).astype(np.float32)
    q[0, 1] = 0.79  # about to pass the angle limit
    q[1, 0], q[1, 2] = 2.39, 1.0  # about to leave the track
    step_counter = rng.randint(0, max_len, B).astype(np.int32)
    step_counter[2] = max_len - 1  # truncates on this step
    actions = rng.uniform(-1.5, 1.5, (B, 1)).astype(np.float32)

    jax_env = JaxEpisodeWrapper(JaxCartpoleBalance(), max_len)
    env = EpisodeWrapper(CartpoleBalance(), max_len)
    jax_state = _jax_env_states(jax_env, q, step_counter)
    state = State(
        data={"q": torch.from_numpy(q)},
        obs=None,
        reward=None,
        done=torch.zeros(B),
        info={"step_counter": torch.from_numpy(step_counter), "truncated": torch.zeros(B, dtype=torch.bool)},
        metrics={},
    )
    for _ in range(3):
        jax_state = jax.vmap(jax_env.step)(jax_state, jnp.asarray(actions))
        state = env.step(state, torch.from_numpy(actions))
        np.testing.assert_allclose(state.data["q"].numpy(), np.asarray(jax_state.data["q"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state.obs.numpy(), np.asarray(jax_state.obs), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state.reward.numpy(), np.asarray(jax_state.reward), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(state.done.numpy(), np.asarray(jax_state.done))
        np.testing.assert_array_equal(state.info["truncated"].numpy(), np.asarray(jax_state.info["truncated"]))
        np.testing.assert_array_equal(state.info["step_counter"].numpy(), np.asarray(jax_state.info["step_counter"]))
    assert state.done.dtype == torch.float32
    assert state.done[:3].all() and state.info["truncated"][2]


def test_episode_wrapper_reset_staggers_counters():
    env = EpisodeWrapper(CartpoleBalance(), 500)
    state = env.reset(4096, torch.Generator().manual_seed(0))
    counters = state.info["step_counter"]
    assert counters.dtype == torch.int32
    assert int(counters.min()) >= 0 and int(counters.max()) < 250
    assert len(torch.unique(counters)) > 200
    assert not state.done.any() and not state.info["truncated"].any()
    assert float(state.data["q"].abs().max()) < 0.05 * 6


@pytest.mark.parametrize("activation", ["relu", "tanh", "swish", "gelu"])
def test_named_activations_match_jax(activation):
    from nnx_ppo_tpu.networks.factories import _ACTIVATIONS as JAX_ACTIVATIONS
    from nnx_ppo_tpu_torch.networks.factories import _ACTIVATIONS

    x = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(
        _ACTIVATIONS[activation](torch.from_numpy(x)).numpy(),
        np.asarray(JAX_ACTIVATIONS[activation](jnp.asarray(x))),
        **TOL,
    )


# -- Concat / Parallel: the physics leg's actor-critic ---------------------------

PHYSICS_WIDTHS = (16, 8, 16)  # proprio encoder, command encoder, hidden


def jax_physics_net(seed=0, widths=PHYSICS_WIDTHS):
    """bench.py's physics network (Concat encoder, Parallel critic heads)
    at narrow widths."""
    from nnx_ppo_tpu.networks import Concat as JConcat
    from nnx_ppo_tpu.networks import Parallel as JParallel
    from nnx_ppo_tpu.networks import PPOAdapter as JPPOAdapter
    from nnx_ppo_tpu.networks import Sequential as JSequential
    from nnx_ppo_tpu.networks import make_mlp as jax_make_mlp

    enc_p, enc_c, hidden = widths
    k = jax.random.split(jax.random.key(seed), 7)
    enc = JConcat.create(
        proprio=JaxDense.create(42, enc_p, k[0], jax.nn.relu),
        command=JaxDense.create(3, enc_c, k[1], jax.nn.relu),
    )
    actor = JSequential.create([
        JaxDense.create(enc_p + enc_c, hidden, k[2], jax.nn.relu),
        JaxDense.create(hidden, 24, k[3]),
        JaxSampler.create(k[4], entropy_weight=1e-3),
    ])
    critic = JParallel.create(
        tracking=jax_make_mlp([enc_p + enc_c, hidden, 1], k[5], activation_last_layer=False),
        penalty=jax_make_mlp([enc_p + enc_c, hidden, 1], k[6], activation_last_layer=False),
    )
    return JSequential.create([enc, JPPOAdapter.create(action=actor, value=critic)])


def port_physics_net(jax_net=None, widths=PHYSICS_WIDTHS, seed=0):
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
    net = Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])
    return net if jax_net is None else carried_across(jax_net, net)


def test_named_containers_sort_and_check_their_components():
    g = torch.Generator().manual_seed(0)
    concat = Concat.create(zeta=Dense.create(2, 3, g), alpha=Dense.create(4, 5, g))
    assert list(concat.components) == ["alpha", "zeta"]  # sorted, as the JAX pytrees are
    assert concat["alpha"].kernel.shape == (4, 5) and concat.replay_time_static
    x = {"alpha": torch.ones(6, 4), "zeta": torch.ones(6, 2)}
    out = concat(concat.initialize_state(6), x)
    assert out.output.shape == (6, 8) and set(out.next_state) == {"alpha", "zeta"}
    torch.testing.assert_close(out.output[:, :5], concat["alpha"]((), x["alpha"]).output)
    assert concat.reset_state(out.next_state) == {"alpha": (), "zeta": ()}
    with pytest.raises(ValueError, match="at least one"):
        Parallel.create()
    with pytest.raises(ValueError, match="not both"):
        Parallel.create({"a": Dense.create(1, 1, g)}, b=Dense.create(1, 1, g))


def test_concat_parallel_weights_carry_across_by_name():
    jax_net = jax_physics_net()
    net = port_physics_net(jax_net)
    jax_params = jax.tree.leaves(partition_params(jax_net)[0])
    torch_params = [p.detach().numpy() for p in net.parameters()]
    assert len(jax_params) == len(torch_params) == 16  # 8 Dense layers
    # Same traversal order: both keep named children sorted.
    for a, b in zip(jax_params, torch_params):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(
        net[0]["command"].kernel.detach().numpy(),
        np.asarray(jax_net.layers[0].components["command"].kernel),
    )


def test_concat_parallel_forward_and_replay_match_jax():
    """rtol = atol = 1e-5: float32 matmuls of width <= 42 and the
    sampler's log-likelihood sums."""
    jax_net = jax_physics_net()
    net = port_physics_net(jax_net)
    T, B = 3, 5
    rng = np.random.RandomState(7)
    obs = {"proprio": rng.randn(T, B, 42).astype(np.float32),
           "command": rng.randn(T, B, 3).astype(np.float32)}
    jax_state = jax_net.initialize_state(B)
    jax_outs = []
    for step in range(T):
        out = jax_net(jax_state, {k: jnp.asarray(v[step]) for k, v in obs.items()})
        jax_state = out.next_state
        jax_outs.append(out)
    jax_seq = jax.tree.map(lambda *xs: np.stack(xs), *[np_leaves(o) for o in jax_outs])

    out0 = net(
        net.initialize_state(B), {k: torch.from_numpy(v[0]) for k, v in obs.items()},
        to_torch(np_leaves(jax_outs[0].rollout_extras)),
    )
    want0 = jax_outs[0].output
    assert set(out0.output.value_estimates) == {"penalty", "tracking"}
    np.testing.assert_allclose(out0.output.actions.detach().numpy(), np.asarray(want0.actions), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        out0.output.loglikelihoods.detach().numpy(), np.asarray(want0.loglikelihoods), rtol=1e-5, atol=1e-5
    )
    for key in ("penalty", "tracking"):
        got = out0.output.value_estimates[key]
        assert got.shape == (B,)
        np.testing.assert_allclose(
            got.detach().numpy(), np.asarray(want0.value_estimates[key]), rtol=1e-5, atol=1e-5
        )

    output, reg, final = net.replay_sequence(
        net.initialize_state(B), to_torch(obs), torch.zeros(T, B, dtype=torch.bool),
        to_torch(jax_seq.rollout_extras),
    )
    assert final == net.initialize_state(B)
    np.testing.assert_allclose(
        output.loglikelihoods.detach().numpy(), jax_seq.output.loglikelihoods, rtol=1e-5, atol=1e-5
    )
    for key in ("penalty", "tracking"):
        np.testing.assert_allclose(
            output.value_estimates[key].detach().numpy(), jax_seq.output.value_estimates[key],
            rtol=1e-5, atol=1e-5,
        )
    np.testing.assert_allclose(reg.detach().numpy(), jax_seq.regularization_loss, rtol=1e-5, atol=1e-6)


def test_rollout_forward_through_concat_draws_from_the_generator():
    net = port_physics_net()
    obs = {"proprio": torch.randn(4, 42), "command": torch.randn(4, 3)}
    a = net(net.initialize_state(4), obs, None, torch.Generator().manual_seed(1))
    b = net(net.initialize_state(4), obs, None, torch.Generator().manual_seed(1))
    c = net(net.initialize_state(4), obs, None, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a.output.actions, b.output.actions)
    assert not torch.equal(a.output.actions, c.output.actions)
    assert a.output.actions.shape == (4, 12)
    extras = a.rollout_extras
    assert set(extras[0]) == {"command", "proprio"} and set(extras[1]["value"]) == {"penalty", "tracking"}
    net.update_statistics(extras)  # no statistics anywhere: must route without error
