"""GAE port parity: nnx_ppo_tpu_torch.ops.gae against the JAX package's
gae_scan and gae_pallas (interpret mode), on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 in float32, the bound tests/test_gae.py
uses between the JAX implementations themselves (a T-long recurrence in
float32 rounds differently when XLA reorders or fuses the products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.ops.gae import gae_pallas as jax_gae_pallas
from nnx_ppo_tpu.ops.gae import gae_scan as jax_gae_scan
from nnx_ppo_tpu_torch.ops import gae as gae_mod
from nnx_ppo_tpu_torch.ops.gae import gae, gae_cuda, gae_scan

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
