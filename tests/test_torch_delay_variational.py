"""Delay, VariationalBottleneck and AR1VariationalBottleneck of
nnx_ppo_tpu_torch against nnx_ppo_tpu's (mirroring
tests/test_sequence_replay_layers.py and tests/test_fused_replay.py):
the vectorised replays against the step-wise scan and against JAX, a
pytree input, the bottlenecks with their noise injected, the AR1 NaN
sentinel's zero, finite gradient after a reset, and the DummyCounter
carry resets through a Delay.

Tolerance: the Delay moves values without arithmetic, so it is held to
the bit; the bottlenecks rtol 1e-5 / atol 1e-6 on values (float32, the
same formulas; softplus and log reduce in another order of ops) and
rtol 1e-5 / atol 1e-6 on gradients (sums over a few terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.core.struct import tree_where as jax_tree_where
from nnx_ppo_tpu.networks import AR1VariationalBottleneck as JaxAR1
from nnx_ppo_tpu.networks import Delay as JaxDelay
from nnx_ppo_tpu.networks import VariationalBottleneck as JaxVB
from nnx_ppo_tpu_torch.algorithms.rollout import unroll_env
from nnx_ppo_tpu_torch.convert import to_torch
from nnx_ppo_tpu_torch.core.struct import tree_map
from nnx_ppo_tpu_torch.networks import AR1VariationalBottleneck, Delay, VariationalBottleneck
from nnx_ppo_tpu_torch.networks.types import ModuleOutput, PPONetworkOutput, StatefulModule, scan_replay
from nnx_ppo_tpu_torch.test_dummies import DummyCounterEnv, DummyCounterNet

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
EXACT = dict(rtol=0, atol=0)


def warm_delay_state(delay, B, F, seed):
    """A mid-cycle carry: four steps with a reset of env 1 at step 2."""
    rng = np.random.RandomState(seed + 100)
    state = delay.initialize_state(B)
    warm = torch.from_numpy(rng.randn(4, B, F).astype(np.float32))
    warm_done = torch.zeros(4, B, dtype=torch.bool)
    warm_done[2, 1] = True
    _, _, state = scan_replay(delay, state, warm, warm_done, None)
    return state


@pytest.mark.parametrize("k,T", [(1, 9), (2, 9), (3, 9), (7, 9), (3, 2), (2, 1), (5, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_delay_vectorised_replay_equals_the_scan_and_jax(k, T, seed):
    B, F = 5, 3
    rng = np.random.RandomState(seed)
    obs = rng.randn(T, B, F).astype(np.float32)
    done = rng.rand(T, B) < 0.3
    delay = Delay.create(torch.zeros(F), k_steps=k, initial_value=0.5)
    state = warm_delay_state(delay, B, F, seed)

    ref_out, _, ref_final = scan_replay(delay, state, torch.from_numpy(obs), torch.from_numpy(done), None)
    out, reg, final = delay.replay_sequence(state, torch.from_numpy(obs), torch.from_numpy(done), None)
    torch.testing.assert_close(out, ref_out, **EXACT)
    torch.testing.assert_close(final["buffer"], ref_final["buffer"], **EXACT)
    torch.testing.assert_close(final["idx"], ref_final["idx"], **EXACT)
    assert final["idx"].dtype == torch.int32 and reg.shape == (T, B)

    jax_delay = JaxDelay.create(jnp.zeros(F), k_steps=k, initial_value=0.5)
    jax_state = jax.tree.map(lambda x: jnp.asarray(x.numpy()), state)
    want_out, _, want_final = jax_delay.replay_sequence(jax_state, jnp.asarray(obs), jnp.asarray(done), None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(final["buffer"].numpy(), np.asarray(want_final["buffer"]))
    np.testing.assert_array_equal(final["idx"].numpy(), np.asarray(want_final["idx"]))


def test_delay_step_matches_jax_with_pytree_input():
    """A dict input: every step's output and carry against JAX's, with
    resets, then the vectorised replay against the scan."""
    T, B = 6, 4
    sample = {"a": np.zeros(2, np.float32), "b": np.zeros(3, np.float32)}
    rng = np.random.RandomState(2)
    obs = {"a": rng.randn(T, B, 2).astype(np.float32), "b": rng.randn(T, B, 3).astype(np.float32)}
    done = rng.rand(T, B) < 0.25
    jax_delay = JaxDelay.create(jax.tree.map(jnp.asarray, sample), k_steps=2)
    delay = Delay.create(to_torch(sample), k_steps=2)
    jax_state, state = jax_delay.initialize_state(B), delay.initialize_state(B)
    for t in range(T):
        want = jax_delay(jax_state, jax.tree.map(lambda x: jnp.asarray(x[t]), obs))
        got = delay(state, {k: torch.from_numpy(v[t]) for k, v in obs.items()})
        for key in ("a", "b"):
            np.testing.assert_array_equal(got.output[key].numpy(), np.asarray(want.output[key]))
            np.testing.assert_array_equal(got.next_state["buffer"][key].numpy(),
                                          np.asarray(want.next_state["buffer"][key]))
        np.testing.assert_array_equal(got.next_state["idx"].numpy(), np.asarray(want.next_state["idx"]))
        jax_state = jax_tree_where(jnp.asarray(done[t]), jax_delay.reset_state(want.next_state),
                                   want.next_state)
        state = tree_map(lambda a, b: torch.where(
            torch.from_numpy(done[t]).reshape((B,) + (1,) * (a.ndim - 1)), a, b),
            delay.reset_state(got.next_state), got.next_state)

    state0 = delay.initialize_state(B)
    obs_t = to_torch(obs)
    ref_out, _, ref_final = scan_replay(delay, state0, obs_t, torch.from_numpy(done), None)
    out, _, final = delay.replay_sequence(state0, obs_t, torch.from_numpy(done), None)
    for key in ("a", "b"):
        torch.testing.assert_close(out[key], ref_out[key], **EXACT)
        torch.testing.assert_close(final["buffer"][key], ref_final["buffer"][key], **EXACT)


def test_delay_rejects_k_below_one():
    with pytest.raises(ValueError, match="k_steps"):
        Delay.create(torch.zeros(2), k_steps=0)


def test_variational_bottleneck_matches_jax_with_injected_noise():
    """The JAX layer with its noise given as extras against the port's:
    z, KL regularization and metrics; the port's own draw is snapshotted
    and replays to the same z; no generator draws no noise (z = mean)."""
    B, L = 6, 3
    rng = np.random.RandomState(0)
    x = rng.randn(B, 2 * L).astype(np.float32)
    eps = rng.randn(B, L).astype(np.float32)
    jax_vb = JaxVB.create(L, jax.random.key(0), kl_weight=0.3, min_std=1e-3)
    vb = VariationalBottleneck.create(L, kl_weight=0.3, min_std=1e-3)
    want = jax_vb(jax_vb.initialize_state(B), jnp.asarray(x), jnp.asarray(eps))
    got = vb((), torch.from_numpy(x), torch.from_numpy(eps))
    np.testing.assert_allclose(got.output.numpy(), np.asarray(want.output), **TOL)
    np.testing.assert_allclose(got.regularization_loss.numpy(), np.asarray(want.regularization_loss), **TOL)
    for key in ("mu", "sigma", "kl_divergence"):
        np.testing.assert_allclose(got.metrics[key].numpy(), np.asarray(want.metrics[key]), **TOL)
    assert vb.replay_time_static and vb.initialize_state(B) == ()

    drawn = vb((), torch.from_numpy(x), None, torch.Generator().manual_seed(1))
    replay = vb((), torch.from_numpy(x), drawn.rollout_extras)
    torch.testing.assert_close(replay.output, drawn.output, **EXACT)
    mean_only = vb((), torch.from_numpy(x))
    torch.testing.assert_close(mean_only.output, torch.from_numpy(x[:, :L]), **EXACT)


def ar1_pair(bptt: bool):
    kw = dict(kl_weight=0.3, ar1_weight=0.7, backprop_through_time=bptt)
    return JaxAR1.create(3, jax.random.key(0), **kw), AR1VariationalBottleneck.create(3, **kw)


def ar1_inputs(T=7, B=4, L=3, seed=1):
    rng = np.random.RandomState(seed)
    obs = rng.randn(T, B, 2 * L).astype(np.float32)
    eps = rng.randn(T, B, L).astype(np.float32)
    done = rng.rand(T, B) < 0.3
    done[2, 1] = True
    return obs, eps, done


@pytest.mark.parametrize("bptt", [True, False], ids=["bptt", "no_bptt"])
def test_ar1_step_and_replay_match_jax(bptt):
    """The step-wise scan (forward and resets) and the vectorised replay
    against JAX's, with the same noise: outputs, regularization and the
    final ``last_z`` (NaN where the last step was done)."""
    jax_ar1, ar1 = ar1_pair(bptt)
    obs, eps, done = ar1_inputs()
    T, B = done.shape
    jax_state = jax_ar1.initialize_state(B)
    want_out, want_reg, want_final = jax_ar1.replay_sequence(
        jax_state, jnp.asarray(obs), jnp.asarray(done), jnp.asarray(eps)
    )
    args = (torch.from_numpy(obs), torch.from_numpy(done), torch.from_numpy(eps))
    for replay in (ar1.replay_sequence, lambda *a: scan_replay(ar1, *a)):
        out, reg, final = replay(ar1.initialize_state(B), *args)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
        np.testing.assert_allclose(reg.numpy(), np.asarray(want_reg), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(final["last_z"].numpy(), np.asarray(want_final["last_z"]), **TOL)
    assert torch.isnan(final["last_z"][torch.from_numpy(done[-1])]).all()


@pytest.mark.parametrize("bptt", [True, False], ids=["bptt", "no_bptt"])
def test_ar1_gradients_match_jax_and_the_scan(bptt):
    """Gradients of the summed regularization with respect to the input
    sequence: the vectorised replay against JAX's and against the
    port's step-wise scan."""
    jax_ar1, ar1 = ar1_pair(bptt)
    obs, eps, done = ar1_inputs(T=5, B=3)
    B = done.shape[1]

    def jax_loss(o):
        _, reg, _ = jax_ar1.replay_sequence(jax_ar1.initialize_state(B), o, jnp.asarray(done),
                                            jnp.asarray(eps))
        return jnp.sum(reg)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(obs)))
    for replay in (ar1.replay_sequence, lambda *a: scan_replay(ar1, *a)):
        x = torch.from_numpy(obs).requires_grad_(True)
        _, reg, _ = replay(ar1.initialize_state(B), x, torch.from_numpy(done), torch.from_numpy(eps))
        reg.sum().backward()
        assert torch.isfinite(x.grad).all()
        np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bptt", [True, False], ids=["bptt", "no_bptt"])
def test_ar1_sentinel_gives_zero_finite_gradient_after_a_reset(bptt):
    """Right after a reset (and at the first step) the penalty is zero,
    and so is its gradient with respect to that step's input, with no
    NaN from the sentinel reaching the backward pass; one step later the
    gradient reaches back through z (only with backprop through time)."""
    ar1 = AR1VariationalBottleneck.create(2, kl_weight=0.0, ar1_weight=1.0, backprop_through_time=bptt)
    T, B = 4, 2
    obs = torch.from_numpy(np.random.RandomState(3).randn(T, B, 4).astype(np.float32))
    eps = torch.from_numpy(np.random.RandomState(4).randn(T, B, 2).astype(np.float32))
    done = torch.zeros(T, B, dtype=torch.bool)
    done[1, 0] = True  # env 0 resets after step 1: step 2 starts an episode
    for replay in (ar1.replay_sequence, lambda *a: scan_replay(ar1, *a)):
        for t_loss in (0, 2):
            x = obs.clone().requires_grad_(True)
            _, reg, _ = replay(ar1.initialize_state(B), x, done, eps)
            assert torch.isfinite(reg).all() and reg[0].eq(0).all() and reg[2, 0] == 0
            reg[t_loss, 0].backward()
            assert torch.isfinite(x.grad).all()
            assert x.grad[:, 0].eq(0).all(), f"step {t_loss}: {x.grad[:, 0]}"
        x = obs.clone().requires_grad_(True)
        _, reg, _ = replay(ar1.initialize_state(B), x, done, eps)
        reg[3, 0].backward()
        assert torch.isfinite(x.grad).all() and x.grad[3, 0].abs().sum() > 0
        assert (x.grad[2, 0].abs().sum() > 0) == bptt


class _DelayedCounter(StatefulModule):
    """DummyCounterNet whose action passes through a Delay(k) and back:
    the counter delayed by k steps plus k, which equals the counter
    whenever no reset fell in the last k steps."""

    def __init__(self, k: int):
        super().__init__()
        self.counter = DummyCounterNet()
        self.delay = Delay.create(torch.zeros(1), k_steps=k, initial_value=-1e3)
        self.k = k

    def forward(self, state, x, rollout_extras=None, generator=None):
        c = self.counter(state["counter"], x)
        d = self.delay(state["delay"], c.output.actions)
        return ModuleOutput(
            {"counter": c.next_state, "delay": d.next_state},
            PPONetworkOutput(d.output + self.k, c.output.loglikelihoods, c.output.value_estimates),
            0.0, {}, None,
        )

    def initialize_state(self, batch_size):
        return {"counter": self.counter.initialize_state(batch_size),
                "delay": self.delay.initialize_state(batch_size)}

    def reset_state(self, prev_state):
        return {"counter": self.counter.reset_state(prev_state["counter"]),
                "delay": self.delay.reset_state(prev_state["delay"])}


@pytest.mark.parametrize("k", [1, 3])
def test_delay_carry_resets_stay_in_lockstep_with_env_resets(k):
    """DummyCounter through a Delay: the env pays 1 only when the action
    is the step count c since its reset, and the delayed counter plus k
    is c exactly when the value read was written in the same episode
    (c > k): any desync of the Delay's carry reset with the env's shows
    as a different reward pattern."""
    env, net = DummyCounterEnv(), _DelayedCounter(k)
    B, T = 16, 40
    g = torch.Generator().manual_seed(0)
    _, _, rollout = unroll_env(env, env.reset(B, g), net, net.initialize_state(B), T, g)
    expected = torch.zeros(T, B)
    count = torch.zeros(B)
    for t in range(T):
        count += 1
        expected[t] = (count > k).float()
        count = torch.where(rollout.done[t], 0.0, count)
    assert rollout.done.any()
    torch.testing.assert_close(rollout.rewards, expected, **EXACT)
