"""PopulationGraph of nnx_ppo_tpu_torch against nnx_ppo_tpu's: the
``population_graph`` actor of the benchmark suite (sensor -> core with a
delay-1 self-loop -> motor, in Filter / graph / Filter / Flattener /
sampler), step and fused replay, a graph with mixed delays and an LSTM
edge, the SCC group order, the builder's checks and a PPO step.

The JAX weights are carried across by name (the builder's connections
must match, ``convert.load_jax_leaves``). Tolerance: rtol 1e-5 / atol
1e-6 on values and 1e-4 / 1e-6 on gradients (float32, the same summation
order as JAX's; matmuls reduce in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_networks import carried_across, np_leaves

from nnx_ppo_tpu.core.struct import tree_where as jax_tree_where
from nnx_ppo_tpu.networks import LSTM as JaxLSTM
from nnx_ppo_tpu.networks import Filter as JaxFilter
from nnx_ppo_tpu.networks import Flattener as JaxFlattener
from nnx_ppo_tpu.networks import Normalizer as JaxNormalizer
from nnx_ppo_tpu.networks import NormalTanhSampler as JaxSampler
from nnx_ppo_tpu.networks import Sequential as JaxSequential
from nnx_ppo_tpu.networks.graph import PopulationGraph as JaxPopulationGraph
from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer, new_training_state, ppo_multi_step
from nnx_ppo_tpu_torch.convert import load_jax_leaves, to_torch
from nnx_ppo_tpu_torch.core.struct import tree_where
from nnx_ppo_tpu_torch.networks import (
    LSTM,
    Filter,
    Flattener,
    Normalizer,
    NormalTanhSampler,
    PPOAdapter,
    Sequential,
    make_mlp,
)
from nnx_ppo_tpu_torch.networks.graph import Connection, PopulationGraph
from nnx_ppo_tpu_torch.networks.types import scan_replay
from nnx_ppo_tpu_torch.test_dummies import MoveToCenterEnv
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OBS, CORE, ACT = 5, 16, 2


def suite_graph(builder, activation):
    """``benchmarks/suite.py::_population_graph``'s graph at a narrow core."""
    builder.add_input("sensor", OBS, input_from="obs")
    builder.add_population("core", CORE, activation=activation)
    builder.add_output("motor", 2 * ACT)
    builder.connect("sensor", "core")
    builder.connect("core", "core", delay=1)
    builder.connect("core", "motor")
    return builder.finalize()


def actor_pair():
    jax_graph = suite_graph(JaxPopulationGraph.builder(jax.random.key(3)), jnp.tanh)
    jax_actor = JaxSequential.create([
        JaxFilter.create({"obs": lambda x: x}), jax_graph, JaxFilter.create({"motor": "motor"}),
        JaxFlattener.create(), JaxSampler.create(jax.random.key(4), entropy_weight=1e-3),
    ])
    graph = suite_graph(PopulationGraph.builder(3), torch.tanh)
    actor = Sequential.create([
        Filter.create({"obs": lambda x: x}), graph, Filter.create({"motor": "motor"}),
        Flattener.create(), NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    return jax_actor, carried_across(jax_actor, actor)


def port_carry(jax_carry):
    return to_torch(np_leaves(jax_carry))


def jax_stepwise(module, state, obs_seq, done):
    """The JAX actor stepped T times (fresh draws), reset where done:
    outputs, stacked extras, the carry before each step and the last."""
    outs, extras, states = [], [], []
    for t in range(done.shape[0]):
        states.append(state)
        out = module(state, jnp.asarray(obs_seq[t]))
        outs.append(out.output)
        extras.append(out.rollout_extras)
        state = jax_tree_where(jnp.asarray(done[t]), module.reset_state(out.next_state), out.next_state)
    stack = lambda xs: jax.tree.map(lambda *l: jnp.stack(l), *xs)  # noqa: E731
    return stack(outs), stack(extras), states, state


def sequence(T=7, B=4, seed=1):
    rng = np.random.RandomState(seed)
    obs = rng.randn(T, B, OBS).astype(np.float32)
    done = rng.rand(T, B) < 0.3
    done[min(2, T - 1), 1] = True
    return obs, done


def test_actor_step_matches_jax():
    """Each step of the JAX actor (its draws replayed from its extras):
    log-likelihoods, the core's ring buffer and index, with resets."""
    jax_actor, actor = actor_pair()
    obs, done = sequence()
    B = done.shape[1]
    jax_out, jax_extras, jax_states, _ = jax_stepwise(jax_actor, jax_actor.initialize_state(B), obs, done)
    extras = port_carry(jax_extras)
    state = actor.initialize_state(B)
    for t in range(done.shape[0]):
        want_state = port_carry(jax_states[t])[1]["populations"]["core"]
        got_core = state[1]["populations"]["core"]
        torch.testing.assert_close(got_core["buffer"], want_state["buffer"], **TOL)
        torch.testing.assert_close(got_core["buffer_idx"], want_state["buffer_idx"], rtol=0, atol=0)
        out = actor(state, torch.from_numpy(obs[t]), jax.tree.map(lambda x: x[t], extras))
        np.testing.assert_allclose(out.output["log_likelihood"].detach().numpy(),
                                   np.asarray(jax_out["log_likelihood"][t]), **TOL)
        state = tree_where(torch.from_numpy(done[t]), actor.reset_state(out.next_state), out.next_state)


@pytest.mark.parametrize("n_warm", [0, 3])
def test_actor_fused_replay_matches_jax_and_the_scan(n_warm):
    """The fused replay from a carry warmed ``n_warm`` steps, against
    JAX's fused replay (outputs, regularization, final carry, gradients)
    and against the port's own step-wise scan."""
    jax_actor, actor = actor_pair()
    B = 4
    jax_state = jax_actor.initialize_state(B)
    if n_warm:
        warm_obs, warm_done = sequence(n_warm, B, seed=5)
        _, _, _, jax_state = jax_stepwise(jax_actor, jax_state, warm_obs, warm_done)
    obs, done = sequence()
    want_out, jax_extras, _, _ = jax_stepwise(jax_actor, jax_state, obs, done)

    def jax_loss(o):
        out, reg, final = jax_actor.replay_sequence(jax_state, o, jnp.asarray(done), jax_extras)
        return jnp.sum(out["log_likelihood"]) + jnp.sum(reg), (out, reg, final)

    (_, (jax_seq, jax_reg, jax_final)), jax_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(obs))
    np.testing.assert_allclose(np.asarray(jax_seq["log_likelihood"]),
                               np.asarray(want_out["log_likelihood"]), rtol=1e-5, atol=1e-5)
    extras = port_carry(jax_extras)
    results = {}
    for name, replay in (("fused", actor.replay_sequence),
                         ("scan", lambda *a: scan_replay(actor, *a))):
        x = torch.from_numpy(obs).requires_grad_(True)
        out, reg, final = replay(port_carry(jax_state), x, torch.from_numpy(done), extras)
        (out["log_likelihood"].sum() + reg.sum()).backward()
        results[name] = (out["log_likelihood"].detach(), reg.detach(), final, x.grad)
    seq, reg, final, grad = results["fused"]
    np.testing.assert_allclose(seq.numpy(), np.asarray(jax_seq["log_likelihood"]), **TOL)
    np.testing.assert_allclose(reg.numpy(), np.asarray(jax_reg), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jax_grad), **GRAD_TOL)
    want_final = port_carry(jax_final)[1]["populations"]["core"]
    torch.testing.assert_close(final[1]["populations"]["core"]["buffer"], want_final["buffer"], **TOL)
    torch.testing.assert_close(final[1]["populations"]["core"]["buffer_idx"],
                               want_final["buffer_idx"], rtol=0, atol=0)
    s_seq, s_reg, s_final, s_grad = results["scan"]
    torch.testing.assert_close(s_seq, seq, **TOL)
    torch.testing.assert_close(s_reg, reg, **TOL)
    torch.testing.assert_close(s_grad, grad, **GRAD_TOL)
    torch.testing.assert_close(s_final[1]["populations"]["core"]["buffer"],
                               final[1]["populations"]["core"]["buffer"], **TOL)


def mixed_graph(builder, activation, lstm):
    """``tests/test_graph.py``'s graph: a self-recurrent core, a delay-3
    skip edge, an LSTM edge and a delay-2 edge into the output."""
    builder.add_input("inp", 3, input_from="x")
    builder.add_population("core", 4, activation=activation)
    builder.add_output("out", 2)
    builder.connect("inp", "core")
    builder.connect("core", "core", delay=1)
    builder.connect("inp", "core", delay=3)
    builder.connect("core", "out", transform=lstm)
    builder.connect("core", "out", delay=2)
    return builder.finalize()


def test_mixed_delay_graph_with_an_lstm_edge_matches_jax():
    jax_graph = mixed_graph(JaxPopulationGraph.builder(jax.random.key(7)), jnp.tanh,
                            JaxLSTM.create(4, 2, jax.random.key(8)))
    graph = carried_across(jax_graph, mixed_graph(
        PopulationGraph.builder(7), torch.tanh, LSTM.create(4, 2, torch.Generator().manual_seed(8))))
    T, B = 7, 4
    rng = np.random.RandomState(0)
    jax_state = jax_graph.initialize_state(B)
    for _ in range(2):  # nontrivial ring buffers and LSTM carry
        jax_state = jax_graph(jax_state, {"x": jnp.asarray(rng.randn(B, 3).astype(np.float32))}).next_state
    obs = {"x": rng.randn(T, B, 3).astype(np.float32)}
    done = rng.rand(T, B) < 0.3
    state = port_carry(jax_state)
    step = graph(state, to_torch({"x": obs["x"][0]}))
    want_step = jax_graph(jax_state, {"x": jnp.asarray(obs["x"][0])})
    np.testing.assert_allclose(step.output["out"].detach().numpy(), np.asarray(want_step.output["out"]), **TOL)

    want_out, want_reg, want_final = jax_graph.replay_sequence(
        jax_state, jax.tree.map(jnp.asarray, obs), jnp.asarray(done), None)
    out, reg, final = graph.replay_sequence(state, to_torch(obs), torch.from_numpy(done), None)
    np.testing.assert_allclose(out["out"].detach().numpy(), np.asarray(want_out["out"]), **TOL)
    assert reg.shape == (T, B)
    got_leaves = jax.tree.leaves(jax.tree.map(lambda x: x.detach().numpy(), final))
    want_leaves = jax.tree.leaves(want_final)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    _, _, scan_final = scan_replay(graph, state, to_torch(obs), torch.from_numpy(done), None)
    for g, w in zip(jax.tree.leaves(scan_final), jax.tree.leaves(final)):
        torch.testing.assert_close(g, w, **TOL)


def scc_graph(builder, activation):
    """Two recurrent cores (a 3-cycle through delays and a self-loop),
    acyclic populations between them, a delay-0 chain."""
    for name, size in (("a", 2), ("b", 3), ("c", 2), ("d", 2), ("e", 3), ("f", 2)):
        builder.add_population(name, size, activation=activation)
    builder.add_input("in", 2, input_from="x")
    builder.add_output("out", 2)
    builder.connect("in", "b")
    builder.connect("b", "a")
    builder.connect("a", "c", delay=1)
    builder.connect("c", "b", delay=2)
    builder.connect("c", "d")
    builder.connect("d", "e")
    builder.connect("e", "e", delay=1)
    builder.connect("e", "f", delay=3)
    builder.connect("f", "out")
    builder.connect("in", "out", delay=1, reciprocal=True)
    return builder.finalize()


def test_scc_condensation_gives_jax_group_order():
    jax_graph = scc_graph(JaxPopulationGraph.builder(jax.random.key(0)), jnp.tanh)
    graph = scc_graph(PopulationGraph.builder(0), torch.tanh)
    assert graph._condensation() == jax_graph._condensation()
    assert graph.topo_order == jax_graph.topo_order
    assert graph.incoming == jax_graph.incoming
    assert graph.output_pops == jax_graph.output_pops
    jax_suite = suite_graph(JaxPopulationGraph.builder(jax.random.key(3)), jnp.tanh)
    assert suite_graph(PopulationGraph.builder(3), torch.tanh)._condensation() == jax_suite._condensation()
    # And the replay over it against JAX's.
    graph = carried_across(jax_graph, graph)
    T, B = 5, 3
    rng = np.random.RandomState(1)
    obs = {"x": rng.randn(T, B, 2).astype(np.float32)}
    done = rng.rand(T, B) < 0.3
    want, _, want_final = jax_graph.replay_sequence(
        jax_graph.initialize_state(B), jax.tree.map(jnp.asarray, obs), jnp.asarray(done), None)
    got, _, final = graph.replay_sequence(graph.initialize_state(B), to_torch(obs),
                                          torch.from_numpy(done), None)
    np.testing.assert_allclose(got["out"].detach().numpy(), np.asarray(want["out"]), **TOL)
    for g, w in zip(jax.tree.leaves(jax.tree.map(torch.Tensor.detach, final)),
                    jax.tree.leaves(want_final)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_builder_checks():
    b = PopulationGraph.builder(0)
    b.add_population("a", 2)
    with pytest.raises(ValueError, match="already exists"):
        b.add_population("a", 3)
    with pytest.raises(ValueError, match="unknown"):
        b.connect("a", "nope")
    with pytest.raises(ValueError, match="delay"):
        b.connect("a", "a", delay=-1)
    b.add_population("b", 2)
    with pytest.raises(ValueError, match="reciprocal"):
        b.connect("a", "b", transform=Normalizer.create(2), reciprocal=True)
    b.connect("a", "b")
    b.connect("b", "a")
    with pytest.raises(ValueError, match="cycle"):
        b.finalize()
    with pytest.raises(RuntimeError, match="finalized"):
        b.add_population("c", 1)
    with pytest.raises(ValueError):
        Connection("a", "b", -2)


@pytest.mark.parametrize("d", [1, 3])
def test_delayed_read_and_reset(d):
    """An identity edge of delay d: zeros until the buffer fills, then
    the input of d steps before; a reset zeroes the buffers."""
    b = PopulationGraph.builder(0)
    b.add_input("inp", 1, input_from="x")
    b.add_output("out", 1)
    b.connect("inp", "out", delay=d)
    g = b.finalize()
    with torch.no_grad():
        g.transforms[0].kernel.fill_(1.0)
    state = g.initialize_state(1)
    outs = []
    for t in range(6):
        out = g(state, {"x": torch.full((1, 1), float(t + 1))})
        outs.append(out.output["out"][0, 0].item())
        state = out.next_state
    assert outs == [0.0] * d + [float(t + 1) for t in range(6 - d)]
    reset = g.reset_state(state)
    assert not reset["populations"]["inp"]["buffer"].any()
    assert not reset["populations"]["inp"]["buffer_idx"].any()


def test_update_statistics_and_loading_check_the_structure():
    """update_statistics reaches the transforms (a Normalizer edge, as
    JAX's), and the JAX weights load only into the same connections."""
    jax_b = JaxPopulationGraph.builder(jax.random.key(0))
    b = PopulationGraph.builder(0)
    for builder, norm in ((jax_b, JaxNormalizer.create(2)), (b, Normalizer.create(2))):
        builder.add_input("inp", 2, input_from="x")
        builder.add_output("out", 2)
        builder.connect("inp", "out", transform=norm)
    jax_graph, graph = jax_b.finalize(), b.finalize()
    x = np.random.RandomState(0).randn(3, 4, 2).astype(np.float32)
    extras = {"connections": (x,)}
    jax_graph = jax_graph.update_statistics({"connections": (jnp.asarray(x),)})
    graph.update_statistics(to_torch(extras))
    assert float(graph.transforms[0].counter) == float(jax_graph.transforms[0].counter) == 12
    np.testing.assert_allclose(graph.transforms[0].mean.numpy(), np.asarray(jax_graph.transforms[0].mean), **TOL)

    other = PopulationGraph.builder(0)
    other.add_input("inp", 2, input_from="x")
    other.add_output("out", 2)
    other.connect("inp", "out")
    other.connect("inp", "out")
    with pytest.raises(ValueError, match="connections"):
        load_jax_leaves(other.finalize(), np_leaves(jax_graph))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused_scan"])
def test_graph_actor_ppo_step_on_the_cpu(fused):
    """The population_graph net (MLP critic) trains through ppo_step in
    both replay modes; every metric finite, the step count right."""
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    b = PopulationGraph.builder(3)
    b.add_input("sensor", 2, input_from="obs")
    b.add_population("core", 8, activation=torch.tanh)
    b.add_output("motor", 4)
    b.connect("sensor", "core")
    b.connect("core", "core", delay=1)
    b.connect("core", "motor")
    actor = Sequential.create([
        Filter.create({"obs": lambda x: x}), b.finalize(), Filter.create({"motor": "motor"}),
        Flattener.create(), NormalTanhSampler.create(entropy_weight=1e-3),
    ])
    net = PPOAdapter.create(action=actor, value=make_mlp([2, 16, 1], torch.Generator().manual_seed(5),
                                                         activation_last_layer=False))
    config = PPOConfig(n_envs=8, rollout_length=5, n_epochs=2, n_minibatches=2, fused_replay=fused)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(env, net, config.n_envs, seed=0, optimizer=optimizer, device="cpu")
    ts, metrics = ppo_multi_step(env, ts, config, optimizer, n_steps=2, return_history=True)
    assert ts.steps_taken == 2 * 8 * 5
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values())
