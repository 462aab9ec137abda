"""GAE port parity: nnx_ppo_tpu_torch.ops.gae against the JAX package's
gae_scan and gae_pallas (interpret mode), on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 in float32, the bound tests/test_gae.py
uses between the JAX implementations themselves (a T-long recurrence in
float32 rounds differently when XLA reorders or fuses the products).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.ops.gae import gae_pallas as jax_gae_pallas
from nnx_ppo_tpu.ops.gae import gae_scan as jax_gae_scan
from nnx_ppo_tpu_torch.ops.gae import gae, gae_cuda, gae_scan

# The module (``nnx_ppo_tpu_torch.ops.gae`` is the function, as in JAX).
gae_mod = importlib.import_module("nnx_ppo_tpu_torch.ops.gae")

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def numpy_gae(rewards, values, last_value, done, truncated, lam, gamma):
    """The reverse loop of tests/test_gae.py."""
    T, B = rewards.shape
    vals = np.concatenate([values, last_value[None]], axis=0)
    adv = np.zeros((T, B))
    next_adv = np.zeros(B)
    for t in reversed(range(T)):
        next_value = np.where(done[t], 0.0, vals[t + 1])
        delta = rewards[t] + gamma * next_value - vals[t]
        delta = np.where(truncated[t], 0.0, delta)
        next_adv = delta + (1 - done[t]) * gamma * lam * next_adv
        adv[t] = next_adv
    return adv


def random_case(seed, T=13, B=7):
    rng = np.random.RandomState(seed)
    rewards = rng.randn(T, B).astype(np.float32)
    values = rng.randn(T, B).astype(np.float32)
    last_value = rng.randn(B).astype(np.float32)
    done = rng.rand(T, B) < 0.15
    truncated = done & (rng.rand(T, B) < 0.5)
    return rewards, values, last_value, done, truncated


def port(args, done_dtype=torch.bool):
    rewards, values, last_value, done, truncated = (torch.from_numpy(a) for a in args)
    return rewards, values, last_value, done.to(done_dtype), truncated.to(done_dtype)


@pytest.mark.parametrize("done_dtype", [torch.bool, torch.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gae_scan_matches_jax_scan_and_numpy(seed, done_dtype):
    args = random_case(seed)
    lam, gamma = 0.95, 0.99
    got = gae_scan(*port(args, done_dtype), lam, gamma).numpy()
    want_jax = np.asarray(jax_gae_scan(*[jnp.asarray(a) for a in args], lam, gamma))
    np.testing.assert_allclose(got, want_jax, **TOL)
    np.testing.assert_allclose(got, numpy_gae(*args, lam, gamma), **TOL)


def test_gae_scan_matches_jax_pallas_interpret():
    # The Pallas kernel needs B % 128 == 0 on a TPU; interpret mode runs
    # the same kernel body on the CPU.
    args = random_case(7, T=16, B=128)
    lam, gamma = 0.9, 0.97
    want = np.asarray(
        jax_gae_pallas(*[jnp.asarray(a) for a in args], lam, gamma, interpret=True)
    )
    got = gae_scan(*port(args, torch.float32), lam, gamma).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_gae_done_and_truncated_edge_cases():
    """Hand-built flags: a terminal cuts the bootstrap and the tail, a
    truncation zeroes its own TD error and (done being set too) the
    tail; the last step's bootstrap is last_value."""
    T, B = 4, 3
    rewards = np.ones((T, B), np.float32)
    values = np.full((T, B), 0.5, np.float32)
    last_value = np.full(B, 2.0, np.float32)
    done = np.zeros((T, B), bool)
    truncated = np.zeros((T, B), bool)
    done[1, 0] = True  # env 0: terminal at t=1
    done[2, 1] = truncated[2, 1] = True  # env 1: truncated at t=2
    done[T - 1, 2] = True  # env 2: terminal at the last step
    args = (rewards, values, last_value, done, truncated)
    got = gae(*port(args), 0.95, 0.99).numpy()
    want_jax = np.asarray(jax_gae_scan(*[jnp.asarray(a) for a in args], 0.95, 0.99))
    np.testing.assert_allclose(got, want_jax, **TOL)
    np.testing.assert_allclose(got, numpy_gae(*args, 0.95, 0.99), **TOL)
    assert got[2, 1] == 0.0  # truncated step: no TD error, tail cut
    np.testing.assert_allclose(got[1, 0], 1.0 - 0.5)  # bootstrap zeroed


def test_gae_no_done_equals_discounted_sum():
    T, B = 5, 2
    args = (
        np.ones((T, B), np.float32),
        np.zeros((T, B), np.float32),
        np.zeros(B, np.float32),
        np.zeros((T, B), bool),
        np.zeros((T, B), bool),
    )
    adv = gae(*port(args), 1.0, 1.0)
    np.testing.assert_allclose(adv[0].numpy(), T)


def test_gae_dispatch_cpu_uses_plain_version_and_stops_gradient():
    args = port(random_case(3))
    values = args[1].clone().requires_grad_(True)
    before = gae_cuda.launches
    out = gae(args[0], values, args[2], args[3], args[4], 0.95, 0.99)
    assert gae_cuda.launches == before  # no kernel launch for CPU tensors
    assert not out.requires_grad
    np.testing.assert_array_equal(
        out.numpy(), gae_scan(*args, 0.95, 0.99).numpy()
    )


def test_gae_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        gae_cuda(*port(random_case(0)), 0.95, 0.99)


def test_kernel_source_exists_and_builds_nothing_at_import():
    assert (gae_mod.cuda_build.CSRC_DIR / "gae.cu").is_file()
    assert gae_mod._gae_forward.cache_info().currsize == 0


# -- every reward key at once: gae_per_key --------------------------------------

KEY_NAMES = ("tracking", "penalty", "energy")
# gae_per_key against JAX's gae_scan per key: both run the same float32
# operations in the same order over T = 13 steps, but XLA on the CPU may
# contract a product and a sum into one fused multiply-add, which moves
# the last bit of a step; 1e-6 (relative and absolute, on advantages of
# order 1-10) covers that over the recurrence and nothing more.
PER_KEY_TOL = dict(rtol=1e-6, atol=1e-6)


def per_key_case(n_keys, seed, T=13, B=7):
    """numpy inputs of ``n_keys`` reward keys: dicts of rewards, values
    and last values, and per-key flags (``done`` differs per key)."""
    rng = np.random.RandomState(seed)
    keys = KEY_NAMES[:n_keys]
    rewards = {k: rng.randn(T, B).astype(np.float32) for k in keys}
    values = {k: rng.randn(T, B).astype(np.float32) for k in keys}
    last = {k: rng.randn(B).astype(np.float32) for k in keys}
    done = {k: rng.rand(T, B) < 0.15 for k in keys}
    truncated = {k: done[k] & (rng.rand(T, B) < 0.5) for k in keys}
    return rewards, values, last, done, truncated


def to_torch(tree, dtype=None):
    out = {k: torch.from_numpy(v) for k, v in tree.items()}
    return out if dtype is None else {k: v.to(dtype) for k, v in out.items()}


@pytest.mark.parametrize("flag_dtype", [torch.bool, torch.float32], ids=["bool", "float"])
@pytest.mark.parametrize("flags", ["shared", "per_key"])
@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_gae_per_key_matches_jax_scan_per_key(n_keys, flags, flag_dtype):
    rewards, values, last, done, truncated = per_key_case(n_keys, seed=n_keys)
    if flags == "shared":
        first = KEY_NAMES[0]
        done = {k: done[first] for k in done}
        truncated = {k: truncated[first] for k in truncated}
        done_in, trunc_in = (torch.from_numpy(x[first]).to(flag_dtype) for x in (done, truncated))
    else:
        done_in, trunc_in = to_torch(done, flag_dtype), to_torch(truncated, flag_dtype)
    lam, gamma = 0.95, 0.99
    before = gae_cuda.launches
    got = gae_mod.gae_per_key(to_torch(rewards), to_torch(values), to_torch(last), done_in,
                              trunc_in, lam, gamma)
    assert gae_cuda.launches == before  # the plain version for CPU tensors
    assert set(got) == set(rewards)
    for k in rewards:
        want = np.asarray(jax_gae_scan(*(jnp.asarray(x[k]) for x in
                                         (rewards, values, last, done, truncated)), lam, gamma))
        np.testing.assert_allclose(got[k].numpy(), want, **PER_KEY_TOL)


def test_gae_per_key_on_the_cpu_is_gae_scan_per_key_to_the_bit():
    """Keys are matched by name (a flag dict in another key order), a
    single tensor is one key, and the result carries no gradient."""
    rewards, values, last, done, truncated = (to_torch(x) for x in per_key_case(2, seed=4))
    values = {k: v.requires_grad_(True) for k, v in values.items()}
    done_reordered = {k: done[k] for k in reversed(list(done))}
    got = gae_mod.gae_per_key(rewards, values, last, done_reordered, truncated, 0.9, 0.97)
    for k in rewards:
        want = gae_scan(rewards[k], values[k], last[k], done[k], truncated[k], 0.9, 0.97)
        assert torch.equal(got[k], want) and not got[k].requires_grad
    single = gae_mod.gae_per_key(rewards["tracking"], values["tracking"], last["tracking"],
                                 done["tracking"], truncated["tracking"], 0.9, 0.97)
    assert torch.equal(single, got["tracking"])
    with pytest.raises(KeyError):
        gae_mod.gae_per_key(rewards, values, {"tracking": last["tracking"]}, done, truncated,
                            0.9, 0.97)


def test_ppo_loss_bits_unchanged_by_the_switch_to_gae_per_key(monkeypatch):
    """ppo_loss on the CPU on a two-key rollout (the physics network, dict
    rewards, combined advantages): loss, metrics and gradients through
    gae_per_key are the bits of the per-key calls it replaced."""
    from nnx_ppo_tpu_torch.algorithms import ppo as ppo_module
    from nnx_ppo_tpu_torch.algorithms import LoggingLevel
    from nnx_ppo_tpu_torch.core.struct import tree_map
    from test_torch_networks import jax_physics_net, port_physics_net
    from test_torch_ppo import LOSS_KW, _physics_rollout, port_transition

    jax_net = jax_physics_net(seed=1)
    rollout = port_transition(_physics_rollout(jax_net, 6, 10, seed=5))
    assert set(rollout.rewards) == {"tracking", "penalty"}
    assert rollout.done.dtype == torch.bool and rollout.done.any()
    kw = dict(LOSS_KW, combine_advantages=True, logging_level=LoggingLevel.LOSSES)

    def loss_and_grads():
        net = port_physics_net(jax_net)
        loss, metrics = ppo_module.ppo_loss(net, net.initialize_state(10), rollout, **kw)
        loss.backward()
        return loss, metrics, [p.grad for p in net.parameters()]

    after = loss_and_grads()

    def per_key_calls(rewards, values, last_values, done, truncated, lambda_, gamma,
                      batch_major=False):
        # The code before the switch: the shared flags broadcast to every
        # key, then one gae call per key (a Transition replays time-major).
        assert not batch_major
        done = tree_map(lambda _: done, rewards)
        truncated = tree_map(lambda _: truncated, rewards)
        return tree_map(lambda r, v, v_last, d, tr: gae(r, v.detach(), v_last, d, tr,
                                                        lambda_=lambda_, gamma=gamma),
                        rewards, values, last_values, done, truncated)

    monkeypatch.setattr(ppo_module, "gae_per_key", per_key_calls)
    before = loss_and_grads()
    assert torch.equal(after[0], before[0])
    for key in ("tracking", "penalty"):
        assert torch.equal(after[1]["losses/critic"][key], before[1]["losses/critic"][key])
    assert all(torch.equal(a, b) for a, b in zip(after[2], before[2]))
