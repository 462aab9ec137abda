"""GRU and LSTM of nnx_ppo_tpu_torch against nnx_ppo_tpu's: one step, the
hoisted sequence replay with resets mid-sequence, its gradients, with and
without a trainable initial state, on the same seeded numpy inputs and
the JAX weights carried across by name.

Tolerance: rtol 1e-5 / atol 1e-6 on values (float32 on both sides, the
same arithmetic; the matmuls reduce in another order), rtol 1e-4 / atol
1e-6 on gradients (sums over T * B terms through T steps of the cell).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_networks import carried_across

from nnx_ppo_tpu.core.struct import combine, partition_params
from nnx_ppo_tpu.networks import GRU as JaxGRU
from nnx_ppo_tpu.networks import LSTM as JaxLSTM
from nnx_ppo_tpu_torch.convert import to_torch
from nnx_ppo_tpu_torch.networks import GRU, LSTM
from nnx_ppo_tpu_torch.networks.types import scan_replay

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
IN, H, T, B = 3, 5, 6, 4
CELLS = {"gru": (JaxGRU, GRU), "lstm": (JaxLSTM, LSTM)}


def cell_pair(name: str, trainable: bool, seed: int = 0):
    """The JAX cell (with a random initial state when trainable) and the
    port's with its weights."""
    jax_cls, cls = CELLS[name]
    jax_cell = jax_cls.create(IN, H, jax.random.key(seed), trainable_initial_state=trainable)
    rng = np.random.RandomState(seed + 10)
    jax_cell = jax_cell.replace(bias=jnp.asarray(0.3 * rng.randn(*jax_cell.bias.shape), jnp.float32))
    if trainable:
        jax_cell = jax_cell.replace(initial_h=jnp.asarray(rng.randn(H), jnp.float32))
        if name == "lstm":
            jax_cell = jax_cell.replace(initial_c=jnp.asarray(rng.randn(H), jnp.float32))
    cell = cls.create(IN, H, torch.Generator().manual_seed(seed), trainable_initial_state=trainable)
    return jax_cell, carried_across(jax_cell, cell)


def inputs(name: str, seed: int = 1):
    """A carry, a [T, B, IN] sequence and a done pattern with resets in
    the middle (and one env that never resets)."""
    rng = np.random.RandomState(seed)
    h = rng.randn(B, H).astype(np.float32)
    state = (h, rng.randn(B, H).astype(np.float32)) if name == "lstm" else h
    obs = rng.randn(T, B, IN).astype(np.float32)
    done = rng.rand(T, B) < 0.3
    done[2, 0] = done[T - 1, 1] = True
    done[:, 3] = False
    return state, obs, done


def assert_tree_close(got, want, **tol):
    got_leaves = jax.tree.leaves(jax.tree.map(lambda x: x.detach().numpy(), got))
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), **tol)


@pytest.mark.parametrize("trainable", [False, True], ids=["zero_init", "trainable_init"])
@pytest.mark.parametrize("name", list(CELLS))
def test_step_matches_jax(name, trainable):
    jax_cell, cell = cell_pair(name, trainable)
    state, obs, _ = inputs(name)
    want = jax_cell(jax.tree.map(jnp.asarray, state), jnp.asarray(obs[0]))
    got = cell(to_torch(state), torch.from_numpy(obs[0]))
    assert_tree_close(got.output, want.output, **TOL)
    assert_tree_close(got.next_state, want.next_state, **TOL)
    assert got.regularization_loss.shape == (B,)
    assert_tree_close(cell.initialize_state(B), jax_cell.initialize_state(B), rtol=0, atol=0)


@pytest.mark.parametrize("trainable", [False, True], ids=["zero_init", "trainable_init"])
@pytest.mark.parametrize("name", list(CELLS))
def test_replay_with_resets_matches_jax(name, trainable):
    jax_cell, cell = cell_pair(name, trainable)
    state, obs, done = inputs(name)
    want_out, want_reg, want_final = jax_cell.replay_sequence(
        jax.tree.map(jnp.asarray, state), jnp.asarray(obs), jnp.asarray(done), None
    )
    got_out, got_reg, got_final = cell.replay_sequence(
        to_torch(state), torch.from_numpy(obs), torch.from_numpy(done), None
    )
    assert_tree_close(got_out, want_out, **TOL)
    assert_tree_close(got_final, want_final, **TOL)
    assert got_reg.shape == (T, B) and not got_reg.any()
    # Env 3 never resets, so its carry is the last output; env 1 was
    # reset after the last step.
    h_final = got_final[0] if name == "lstm" else got_final
    torch.testing.assert_close(h_final[3], got_out[-1, 3], rtol=0, atol=0)
    reset_h = cell.reset_state(got_final)[0] if name == "lstm" else cell.reset_state(got_final)
    torch.testing.assert_close(h_final[1], reset_h[1], rtol=0, atol=0)


@pytest.mark.parametrize("trainable", [False, True], ids=["zero_init", "trainable_init"])
@pytest.mark.parametrize("name", list(CELLS))
def test_replay_gradients_match_jax(name, trainable):
    """Gradients of a weighted sum of the outputs and the final carry
    with respect to every parameter, ``initial_h`` / ``initial_c``
    (reached only through the resets) included."""
    jax_cell, cell = cell_pair(name, trainable)
    state, obs, done = inputs(name)
    rng = np.random.RandomState(7)
    w_out = rng.randn(T, B, H).astype(np.float32)
    w_final = rng.randn(B, H).astype(np.float32)
    params, rest = partition_params(jax_cell)

    def jax_loss(p):
        out, _, final = combine(p, rest).replay_sequence(
            jax.tree.map(jnp.asarray, state), jnp.asarray(obs), jnp.asarray(done), None
        )
        h = final[0] if name == "lstm" else final
        return jnp.sum(out * w_out) + jnp.sum(h * w_final)

    jax_grads = jax.grad(jax_loss)(params)
    out, _, final = cell.replay_sequence(
        to_torch(state), torch.from_numpy(obs), torch.from_numpy(done), None
    )
    h = final[0] if name == "lstm" else final
    (torch.sum(out * torch.from_numpy(w_out)) + torch.sum(h * torch.from_numpy(w_final))).backward()
    names = [n for n, _ in cell.named_parameters()]
    assert names == (["wi", "wh", "bias"] + (["initial_h", "initial_c"][: 2 if name == "lstm" else 1]
                                             if trainable else []))
    for n, p in cell.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(getattr(jax_grads, n)), err_msg=n, **GRAD_TOL
        )
    if trainable:
        assert cell.initial_h.grad.abs().sum() > 0  # the resets reached it


@pytest.mark.parametrize("trainable", [False, True], ids=["zero_init", "trainable_init"])
@pytest.mark.parametrize("name", list(CELLS))
def test_hoisted_replay_equals_the_stepwise_scan(name, trainable):
    """The hoisted projection against the step-wise scan of the cell's
    own forward (``scan_replay``): outputs, final carry and gradients
    within float32 reassociation (x @ wi + h @ wh + b against
    (x @ wi + b) + h @ wh)."""
    _, cell = cell_pair(name, trainable, seed=3)
    state, obs, done = inputs(name, seed=4)
    results = []
    for replay in (cell.replay_sequence, lambda *a: scan_replay(cell, *a)):
        cell.zero_grad(set_to_none=True)
        out, reg, final = replay(to_torch(state), torch.from_numpy(obs), torch.from_numpy(done), None)
        (out.square().sum() + sum(x.sum() for x in jax.tree.leaves(final))).backward()
        results.append((out.detach(), reg, jax.tree.map(torch.Tensor.detach, final),
                        [p.grad.clone() for p in cell.parameters()]))
    (out_a, reg_a, final_a, grads_a), (out_b, reg_b, final_b, grads_b) = results
    torch.testing.assert_close(out_a, out_b, **TOL)
    torch.testing.assert_close(reg_a, reg_b, rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(final_a), jax.tree.leaves(final_b)):
        torch.testing.assert_close(a, b, **TOL)
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(a, b, **GRAD_TOL)


@pytest.mark.parametrize("name", list(CELLS))
def test_initial_state_is_data_and_the_reset_is_trainable(name):
    """initialize_state hands out a detached copy of the trainable
    initial state (a carry is data, as JAX's training state holds it);
    reset_state keeps the gradient path to it."""
    _, cell = cell_pair(name, trainable=True)
    fresh = cell.initialize_state(B)
    for leaf in jax.tree.leaves(fresh):
        assert leaf.shape == (B, H) and not leaf.requires_grad
    torch.testing.assert_close(jax.tree.leaves(fresh)[0][2], cell.initial_h.detach(), rtol=0, atol=0)
    reset = cell.reset_state(fresh)
    assert all(leaf.requires_grad for leaf in jax.tree.leaves(reset))
    _, plain = cell_pair(name, trainable=False)
    assert plain.initial_h is None and not jax.tree.leaves(plain.initialize_state(B))[0].any()
    assert plain.replay_unroll == 1 and not plain.replay_time_static


def test_train_ppo_learns_move_to_center_with_a_gru_net_on_the_cpu():
    """train_ppo of a GRU actor-critic (the fused replay) on
    MoveToCenterEnv (50-step episodes) on the CPU: the deterministic
    eval's mean episode reward (at most 50) rises from its start by more
    than 5 and past 33 within 24 iterations of 64 envs x 16 steps (seed 0
    reads 27.2, 35.5, 36.2 at 0, 12 and 24 iterations; seed 1 6.9, 35.3,
    35.8)."""
    from nnx_ppo_tpu_torch.algorithms import EvalConfig, PPOConfig, TrainConfig, train_ppo
    from nnx_ppo_tpu_torch.networks import Dense, NormalTanhSampler, PPOAdapter, Sequential
    from nnx_ppo_tpu_torch.test_dummies import MoveToCenterEnv
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    g = torch.Generator().manual_seed(0)
    net = PPOAdapter.create(
        action=Sequential.create([GRU.create(2, 32, g), Dense.create(32, 4, g),
                                  NormalTanhSampler.create(entropy_weight=3e-3, min_std=0.05)]),
        value=Sequential.create([GRU.create(2, 32, g), Dense.create(32, 1, g)]),
    )
    per_iter = 64 * 16
    config = TrainConfig(
        ppo=PPOConfig(n_envs=64, rollout_length=16, total_steps=24 * per_iter,
                      learning_rate=1e-3, gradient_clipping=1.0),
        eval=EvalConfig(n_envs=64, max_episode_length=50, every_steps=12 * per_iter,
                        logging_percentiles=None),
        seed=0,
    )
    res = train_ppo(EpisodeWrapper(MoveToCenterEnv(), 50), net, config, device="cpu")
    rewards = [row["episode_reward/mean"] for row in res.eval_history]
    assert len(rewards) == 3 and all(np.isfinite(rewards))
    assert rewards[-1] > rewards[0] + 5.0 and rewards[-1] > 33.0, rewards
