"""Utility layers, Splitter, ActionSampler, the pytree Normalizer and the
bf16 ``compute_dtype`` of nnx_ppo_tpu_torch against nnx_ppo_tpu's, on the
same seeded numpy inputs and the JAX weights carried across by name.

Tolerance: layers that only route or slice are held to the bit; float32
arithmetic rtol 1e-5 / atol 1e-6 (the same formulas, matmuls reduced in
another order); bf16 compute as stated in its tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_networks import carried_across, np_leaves

import nnx_ppo_tpu.networks as jax_networks
from nnx_ppo_tpu.networks import Dense as JaxDense
from nnx_ppo_tpu.networks import Filter as JaxFilter
from nnx_ppo_tpu.networks import Flattener as JaxFlattener
from nnx_ppo_tpu.networks import Map as JaxMap
from nnx_ppo_tpu.networks import Merge as JaxMerge
from nnx_ppo_tpu.networks import Normalizer as JaxNormalizer
from nnx_ppo_tpu.networks import Scale as JaxScale
from nnx_ppo_tpu.networks import Splitter as JaxSplitter
from nnx_ppo_tpu.networks import make_mlp_actor_critic as jax_make_mlp_actor_critic
import nnx_ppo_tpu_torch.networks as networks
from nnx_ppo_tpu_torch.convert import load_jax_leaves, to_torch
from nnx_ppo_tpu_torch.networks import (
    ActionSampler,
    Dense,
    Filter,
    Flattener,
    Map,
    Merge,
    Normalizer,
    NormalTanhSampler,
    Scale,
    Splitter,
    make_mlp_actor_critic,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
EXACT = dict(rtol=0, atol=0)
T, B = 3, 4


def tree_obs(lead=(B,), seed=0):
    """A nested dict observation whose keys are not in sorted order."""
    rng = np.random.RandomState(seed)
    return {
        "z": rng.randn(*lead, 2).astype(np.float32),
        "a": {"y": rng.randn(*lead, 3).astype(np.float32),
              "b": rng.randn(*lead, 2, 2).astype(np.float32)},
    }


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_tree_equal(got, want, **tol):
    got_leaves = jax.tree.leaves(jax.tree.map(lambda x: x.detach().numpy(), got))
    want_leaves = jax.tree.leaves(want)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jax.tree.map(
        lambda x: x.detach().numpy(), got))) == jax.tree.structure(jax.tree.map(lambda x: 0, want))
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), **(tol or EXACT))


def test_every_public_name_is_exported():
    assert set(jax_networks.__all__) <= set(networks.__all__)
    from nnx_ppo_tpu_torch.networks.graph import PopulationGraph, PopulationGraphBuilder

    assert PopulationGraph.builder(0).__class__ is PopulationGraphBuilder
    assert networks.StatefulModuleOutput is networks.ModuleOutput


@pytest.mark.parametrize("levels", [0, 1])
def test_flattener_step_and_replay_match_jax(levels):
    """Leaves in JAX's order (dict keys sorted); the replay keeps both
    [T, B] axes."""
    jax_flat, flat = JaxFlattener.create(levels), Flattener.create(levels)
    obs = tree_obs()
    want = jax_flat((), jnp_tree(obs)).output
    assert_tree_equal(flat((), to_torch(obs)).output, want)
    seq = tree_obs((T, B), seed=1)
    want_seq, want_reg, _ = jax_flat.replay_sequence((), jnp_tree(seq), jnp.zeros((T, B), bool), None)
    got_seq, got_reg, state = flat.replay_sequence((), to_torch(seq), torch.zeros(T, B, dtype=torch.bool), None)
    assert_tree_equal(got_seq, want_seq)
    assert got_reg.shape == (T, B) and state == ()
    with pytest.raises(ValueError):
        Flattener.create(-1)
    with pytest.raises(TypeError, match="preserved level"):
        Flattener.create(2)((), {"z": torch.zeros(B, 2)})


def test_filter_and_scale_match_jax():
    spec = {"first": "z", "deep": ("a", "b"), "fn": lambda x: x["a"]["y"] * 2.0}
    jax_filter, flt = JaxFilter.create(spec), Filter.create(spec)
    obs = tree_obs()
    got = flt((), to_torch(obs)).output
    assert list(got) == ["first", "deep", "fn"]
    assert_tree_equal(got, jax_filter((), jnp_tree(obs)).output)
    assert flt.replay_time_static
    assert_tree_equal(Scale.create(-2.5)((), to_torch(obs)).output,
                      JaxScale.create(-2.5)((), jnp_tree(obs)).output)
    with pytest.raises(TypeError):
        Filter.create([("a", "b")])
    with pytest.raises(TypeError):
        Filter.create({"a": 3})


def test_merge_and_map_match_jax():
    """Merge of two Filters (dict outputs), Map of two Dense layers over
    the matching input keys, step and replay; Merge refuses a key made
    twice."""
    obs = {"p": np.random.RandomState(0).randn(B, 3).astype(np.float32),
           "q": np.random.RandomState(1).randn(B, 2).astype(np.float32)}
    merge_children = dict(one=({"x": "p"},), two=({"y": "q"},))
    jax_merge = JaxMerge.create({k: JaxFilter.create(*v) for k, v in merge_children.items()})
    merge = Merge.create({k: Filter.create(*v) for k, v in merge_children.items()})
    assert_tree_equal(merge(merge.initialize_state(B), to_torch(obs)).output,
                      jax_merge(jax_merge.initialize_state(B), jnp_tree(obs)).output)
    with pytest.raises(ValueError, match="duplicate"):
        Merge.create(a=Filter.create({"x": "p"}), b=Filter.create({"x": "q"}))(
            {"a": (), "b": ()}, to_torch(obs))

    k = jax.random.split(jax.random.key(0), 2)
    jax_map = JaxMap.create(q=JaxDense.create(2, 4, k[1]), p=JaxDense.create(3, 4, k[0]))
    g = torch.Generator().manual_seed(0)
    port_map = carried_across(jax_map, Map.create(q=Dense.create(2, 4, g), p=Dense.create(3, 4, g)))
    assert list(port_map.components) == ["p", "q"]
    extra = dict(obs, ignored=np.zeros((B, 1), np.float32))
    assert_tree_equal(port_map(port_map.initialize_state(B), to_torch(extra)).output,
                      jax_map(jax_map.initialize_state(B), jnp_tree(extra)).output, **TOL)
    seq = {key: np.random.RandomState(2).randn(T, B, v.shape[-1]).astype(np.float32)
           for key, v in obs.items()}
    done = np.zeros((T, B), bool)
    for jax_mod, mod in ((jax_map, port_map), (jax_merge, merge)):
        want, want_reg, _ = jax_mod.replay_sequence(jax_mod.initialize_state(B), jnp_tree(seq),
                                                    jnp.asarray(done), None)
        got, got_reg, _ = mod.replay_sequence(mod.initialize_state(B), to_torch(seq),
                                              torch.from_numpy(done), None)
        assert_tree_equal(got, want, **TOL)


def test_splitter_matches_jax():
    x = np.random.RandomState(0).randn(T, B, 7).astype(np.float32)
    jax_split, split = JaxSplitter.create(a=2, b=4), Splitter.create(a=2, b=4)
    assert list(split((), torch.from_numpy(x)).output) == ["a", "b"]
    assert_tree_equal(split((), torch.from_numpy(x)).output, jax_split((), jnp.asarray(x)).output)
    with pytest.raises(ValueError):
        Splitter.create()
    with pytest.raises(ValueError):
        Splitter.create(a=0)


def test_action_sampler_base_class():
    sampler = NormalTanhSampler.create()
    assert isinstance(sampler, ActionSampler) and issubclass(ActionSampler, networks.StatefulModule)
    assert not sampler.deterministic
    sampler.eval()
    assert sampler.deterministic
    x = torch.randn(B, 4, generator=torch.Generator().manual_seed(0))
    out = sampler((), x, None, torch.Generator().manual_seed(1))
    torch.testing.assert_close(out.output["action"], torch.tanh(x[:, :2]), **EXACT)


def test_pytree_normalizer_matches_jax():
    """A nested dict of observations: one Welford per leaf, one shared
    counter, std 10 before the first fold; forward, fold and loading the
    JAX statistics by name."""
    shape = {"z": 2, "a": {"y": (3,), "b": (2, 2)}}
    jax_norm, norm = JaxNormalizer.create(shape), Normalizer.create(shape)
    obs = tree_obs()
    assert_tree_equal(norm((), to_torch(obs)).output, jax_norm((), jnp_tree(obs)).output, **TOL)
    history = tree_obs((5, B), seed=3)
    jax_norm = jax_norm.update_statistics(jnp_tree(history))
    norm.update_statistics(to_torch(history))
    assert float(norm.counter) == float(jax_norm.counter) == 5 * B
    assert_tree_equal(norm.mean.tree(), jax_norm.mean, **TOL)
    assert_tree_equal(norm.M2.tree(), jax_norm.M2, rtol=1e-5, atol=1e-5)
    out = norm((), to_torch(obs))
    assert_tree_equal(out.output, jax_norm((), jnp_tree(obs)).output, rtol=1e-5, atol=1e-5)
    assert out.rollout_extras["a"]["y"] is not None

    fresh = load_jax_leaves(Normalizer.create(shape), np_leaves(jax_norm))
    assert_tree_equal(fresh((), to_torch(obs)).output, jax_norm((), jnp_tree(obs)).output,
                      rtol=1e-5, atol=1e-5)
    assert {n for n, _ in fresh.named_buffers()} == {
        "counter", "mean.z", "mean.a.y", "mean.a.b", "M2.z", "M2.a.y", "M2.a.b"}


def test_tensor_normalizer_keeps_its_formula():
    """The one-tensor form: the same buffers and, to the bit, the formula
    it had before pytrees (var floored at epsilon, std 10 before the
    first fold)."""
    norm = Normalizer.create(3)
    assert {n for n, _ in norm.named_buffers()} == {"mean", "M2", "counter"}
    x = torch.from_numpy(np.random.RandomState(0).randn(B, 3).astype(np.float32))
    torch.testing.assert_close(norm((), x).output, x / 10.0, **EXACT)
    norm.update_statistics(torch.from_numpy(np.random.RandomState(1).randn(5, B, 3).astype(np.float32)))
    std = torch.sqrt(torch.clamp(norm.M2 / torch.clamp(norm.counter, min=1.0), min=1e-6))
    torch.testing.assert_close(norm((), x).output, (x - norm.mean) / std, **EXACT)


def test_bf16_dense_matches_jax():
    """compute_dtype bf16: operands rounded to bf16, float32 products and
    sums, float32 output. The forward products are exact on both sides,
    so only the float32 sum order differs (rtol 1e-5 / atol 1e-6). The
    gradients are rounded to bf16 at the operands, as JAX's are: a sum
    in another order can round to the next bf16 value, one bf16 step
    (2^-8 to 2^-7 = 7.8e-3 of the value), so rtol 8e-3 / atol 1e-6."""
    rng = np.random.RandomState(0)
    x = rng.randn(6, 16).astype(np.float32)
    jax_dense = JaxDense.create(16, 8, jax.random.key(0), jax.nn.relu, compute_dtype=jnp.bfloat16)
    jax_dense = jax_dense.replace(bias=jnp.asarray(rng.randn(8), jnp.float32))
    dense = carried_across(jax_dense, Dense.create(16, 8, torch.Generator(), torch.relu,
                                                   compute_dtype="bfloat16"))
    assert dense.compute_dtype is torch.bfloat16 and dense.kernel.dtype == torch.float32
    w = rng.randn(6, 8).astype(np.float32)

    def jax_loss(d, xx):
        out = d((), xx).output
        return jnp.sum(out * w), out

    (jax_val, jax_out), (jax_grads, jax_gx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jax_dense, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = dense((), xt).output
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jax_out), **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    grad_tol = dict(rtol=8e-3, atol=1e-6)
    np.testing.assert_allclose(dense.kernel.grad.numpy(), np.asarray(jax_grads.kernel), **grad_tol)
    np.testing.assert_allclose(dense.bias.grad.numpy(), np.asarray(jax_grads.bias), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax_gx), **grad_tol)
    # The f32 layer is not the bf16 one: the rounding shows.
    f32 = Dense(dense.kernel.detach(), dense.bias.detach(), torch.relu)
    assert not torch.equal(f32((), torch.from_numpy(x)).output, out.detach())


def test_bf16_mlp_actor_critic_matches_jax():
    """make_mlp_actor_critic(compute_dtype="bfloat16") against JAX's: the
    log-likelihood and value of a replayed step. Each layer's input is
    rounded to bf16, and a float32 sum in another order can round to the
    next bf16 value (2^-8 to 2^-7 of it), which the next layers carry on:
    rtol 2e-2 / atol 2e-3."""
    jax_net = jax_make_mlp_actor_critic(5, 2, [32, 32], [32], jax.random.key(0),
                                        compute_dtype="bfloat16", entropy_weight=1e-3)
    net = carried_across(jax_net, make_mlp_actor_critic(5, 2, [32, 32], [32], 0,
                                                        compute_dtype="bfloat16", entropy_weight=1e-3))
    assert all(layer.compute_dtype is torch.bfloat16
               for layer in net.modules() if isinstance(layer, Dense))
    obs = np.random.RandomState(1).randn(B, 5).astype(np.float32)
    want = jax_net(jax_net.initialize_state(B), jnp.asarray(obs))
    got = net(net.initialize_state(B), torch.from_numpy(obs), to_torch(np_leaves(want.rollout_extras)))
    tol = dict(rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(got.output.loglikelihoods.detach().numpy(),
                               np.asarray(want.output.loglikelihoods), **tol)
    np.testing.assert_allclose(got.output.value_estimates.detach().numpy(),
                               np.asarray(want.output.value_estimates), **tol)
