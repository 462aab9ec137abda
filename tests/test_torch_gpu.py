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
from nnx_ppo_tpu_torch.physics.cuda_step import ControlStepPlan, control_step_cuda
from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
from nnx_ppo_tpu_torch.physics.terrain import rough_terrain
from nnx_ppo_tpu_torch.physics.testing import standing_states
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


# The three control-step configurations that chip_smoke.py checks:
# (batch, n_substeps, exact, full feature set).
CONTROL_STEP_CASES = {
    "held_full_2048": (2048, 10, False, True),
    "exact_full_2048": (2048, 10, True, True),
    "flat_ragged_1000": (1000, 10, False, False),
    "one_substep_full_256": (256, 1, False, True),
    "pairs_limits_planes_512": (512, 10, False, "planes"),
}
DR_FIELDS = ("mass_scale", "friction", "damping_scale", "gain_scale")


def control_step_case(name, device):
    B, n_substeps, exact, full = CONTROL_STEP_CASES[name]
    planes = full == "planes"
    model = make_quadruped(self_collision=planes, joint_limits=planes)
    terrain = rough_terrain(seed=2, amplitude=0.03, wavelength=1.5) if full and not planes else None
    plan = ControlStepPlan(
        model, 60.0, 0.002, n_substeps, exact, terrain=terrain,
        dr_fields=DR_FIELDS if full else (), has_push=bool(full),
        n_terrain_planes=8 if planes else 0,
    )
    arrays = standing_states(
        model, default_qpos(model), B, seed=3, terrain=terrain,
        n_extra_dr=4 if full else 0, has_push=bool(full),
    )
    if planes:
        # Front feet overlapping and pressed together by the PD targets (a
        # sphere pair in contact), a rear abduction joint pushed into its
        # stop (0.86), a knee just past its stop (-0.89), and a gentle
        # tangent plane under each geom.
        arrays["qpos"][::2, 7:13] = [0.38, 0.8, -1.6, -0.38, 0.8, -1.6]
        arrays["target"][::2, 0:6] = [0.6, 0.8, -1.6, -0.6, 0.8, -1.6]
        arrays["qpos"][1::4, 13] = 0.9
        arrays["target"][1::4, 6] = 1.2
        arrays["qpos"][1::4, 15] = -0.88
        rng = np.random.RandomState(9)
        plane_lanes = np.concatenate(
            [0.005 * rng.randn(B, 8, 1), 0.05 * rng.randn(B, 8, 2)], axis=-1
        ).reshape(B, 24)
        arrays["extra"] = np.concatenate([arrays["extra"], plane_lanes], axis=1).astype(np.float32)
    args = [torch.tensor(arrays[k], device=device) for k in ("qpos", "qvel", "target")]
    if full:
        args.append(torch.tensor(arrays["extra"], device=device))
    return plan, args


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CONTROL_STEP_CASES))
def test_control_step_kernel_matches_plain_version(cuda, case):
    """float32 on both; the kernel repeats the plain version's operations
    in its order, but sinf/cosf/sqrtf/division round differently from
    PyTorch's elementwise kernels and the contact switch (phi > 0, 6000
    N/m) amplifies that. One substep: qpos 2e-5, qvel 2e-4; ten substeps:
    qpos 2e-4, qvel 2e-3; normals rtol 5e-3 / atol 5e-2."""
    plan, args = control_step_case(case, cuda)
    before = control_step_cuda.launches
    qpos, qvel, normals = plan(*args)
    assert control_step_cuda.launches == before + 1
    want_qpos, want_qvel, want_normals = plan.plain(*args)
    assert (want_normals > 0).any() and (want_normals == 0).any()
    if want_normals.shape[1] > 8:
        assert (want_normals[:, 8:] > 0).any()  # a sphere pair touches
    tol = 1.0 if plan.n_substeps > 1 else 0.1
    torch.testing.assert_close(qpos, want_qpos, rtol=0, atol=2e-4 * tol)
    torch.testing.assert_close(qvel, want_qvel, rtol=0, atol=2e-3 * tol)
    torch.testing.assert_close(normals, want_normals, rtol=5e-3, atol=5e-2)


@pytest.mark.gpu
def test_control_step_kernel_rejects_wrong_shapes(cuda):
    plan, args = control_step_case("flat_ragged_1000", cuda)
    with pytest.raises(ValueError):
        plan(args[0], args[1][:, :5], args[2])
    with pytest.raises(ValueError):
        plan(*args, torch.zeros(1000, 7, device=cuda))
    with pytest.raises(ValueError):
        plan.cuda(*(x.cpu() for x in args))
