"""Tests of nnx_ppo_tpu_torch that need a CUDA device (marked ``gpu``;
they skip without one). This file imports no JAX, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer, new_training_state, ppo_step
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.ops.gae import gae, gae_cuda, gae_scan
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, B, seed, device):
    rng = np.random.RandomState(seed)
    done = rng.rand(T, B) < 0.15
    truncated = done & (rng.rand(T, B) < 0.5)
    arrays = (
        rng.randn(T, B).astype(np.float32),
        rng.randn(T, B).astype(np.float32),
        rng.randn(B).astype(np.float32),
        done,
        truncated,
    )
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(30, 256), (30, 1024), (7, 1000), (1, 1)])
def test_gae_kernel_matches_plain_version(cuda, shape):
    """Both round every product and sum separately in the same order:
    float32, rtol = atol = 1e-6."""
    args = _inputs(*shape, seed=11, device=cuda)
    before = gae_cuda.launches
    got = gae(*args, 0.95, 0.99)
    assert gae_cuda.launches == before + 1
    torch.testing.assert_close(got, gae_scan(*args, 0.95, 0.99), rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_gae_kernel_rejects_wrong_dtype_and_shape(cuda):
    args = _inputs(5, 8, seed=0, device=cuda)
    with pytest.raises(TypeError):
        gae_cuda(args[0].double(), *args[1:], 0.95, 0.99)
    with pytest.raises(ValueError):
        gae_cuda(args[0], args[1][:4], *args[2:], 0.95, 0.99)


@pytest.mark.gpu
def test_ppo_step_launches_the_gae_kernel_once_per_minibatch(cuda):
    env = EpisodeWrapper(CartpoleBalance(), max_len=12)
    config = PPOConfig(n_envs=256, rollout_length=8)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(
        env, make_mlp_actor_critic(5, 1, [16, 16], [32], 0), 256, seed=0,
        optimizer=optimizer, device=cuda,
    )
    before = gae_cuda.launches
    ts, metrics = ppo_step(env, ts, config, optimizer)
    assert gae_cuda.launches - before == config.n_epochs * config.n_minibatches
    assert torch.isfinite(metrics["losses/actor/mean"])
