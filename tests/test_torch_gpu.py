"""Tests of nnx_ppo_tpu_torch that need a CUDA device (marked ``gpu``;
they skip without one). This file imports no JAX, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import importlib
import numpy as np
import pytest
import torch

from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer, new_training_state, ppo_step
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.ops import cuda_build
from nnx_ppo_tpu_torch.ops.gae import gae, gae_cuda, gae_per_key, gae_scan
from nnx_ppo_tpu_torch.envs import ArmPush, ArmReacher, HumanoidJoystick, QuadrupedJoystick
from nnx_ppo_tpu_torch.envs.pusher import SHOULDER_HEIGHT as PUSHER_SHOULDER_HEIGHT
from nnx_ppo_tpu_torch.physics.cuda_scene_step import (
    make_scene_control_step_runner,
    scene_step_cuda,
    scene_step_plain,
)
from nnx_ppo_tpu_torch.physics.cuda_step import (
    ControlStepPlan,
    control_step_cuda,
    make_control_step_runner,
    make_substep_runner,
    plane_sampler_cuda,
    plane_sampler_plain,
    substeps_cuda,
    substeps_plain,
)
from nnx_ppo_tpu_torch.physics.engine import mass_matrix_factor
from nnx_ppo_tpu_torch.physics.models.humanoid import make_humanoid
from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid, rough_terrain, stairs
from nnx_ppo_tpu_torch.physics.testing import (
    general_tree,
    general_tree_states,
    humanoid_states,
    manipulation_states,
    slider_tree,
    slider_tree_states,
    standing_states,
)
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

# The module (``nnx_ppo_tpu_torch.ops.gae`` is the function, as in JAX).
gae_module = importlib.import_module("nnx_ppo_tpu_torch.ops.gae")


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
    float32, equal to the bit."""
    args = _inputs(*shape, seed=11, device=cuda)
    before = gae_cuda.launches
    got = gae(*args, 0.95, 0.99)
    assert gae_cuda.launches == before + 1
    assert torch.equal(got, gae_scan(*args, 0.95, 0.99))


# (T, B, keys, per-key done, flag dtype, tile rows): the paths' minibatch
# shapes, a batch that ends inside a block with three keys, float flags,
# and rows staged in tiles.
GAE_PER_KEY_CASES = {
    "flagship_30x256": (30, 256, 1, False, torch.bool, 0),
    "quadruped_20x512_two_keys": (20, 512, 2, False, torch.bool, 0),
    "ragged_7x33_three_keys_per_key_done": (7, 33, 3, True, torch.bool, 0),
    "ragged_20x1000_two_keys_float_flags": (20, 1000, 2, True, torch.float32, 0),
    "30x256_rows_in_tiles_of_7": (30, 256, 2, True, torch.bool, 7),
}


def _per_key_inputs(T, B, n_keys, per_key_done, flag_dtype, device):
    keys = [f"k{i}" for i in range(n_keys)]
    inputs = {k: _inputs(T, B, seed=i, device=device) for i, k in enumerate(keys)}
    rewards, values, last = ({k: inputs[k][j] for k in keys} for j in range(3))
    done = {k: inputs[k][3].to(flag_dtype) for k in keys}
    truncated = {k: inputs[k][4].to(flag_dtype) for k in keys}
    if not per_key_done:
        done, truncated = done[keys[0]], truncated[keys[0]]
    return rewards, values, last, done, truncated


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GAE_PER_KEY_CASES))
def test_gae_per_key_is_one_launch_equal_to_gae_scan_per_key(cuda, case):
    T, B, n_keys, per_key_done, flag_dtype, tile_rows = GAE_PER_KEY_CASES[case]
    rewards, values, last, done, truncated = _per_key_inputs(
        T, B, n_keys, per_key_done, flag_dtype, cuda)
    before = gae_cuda.launches
    if tile_rows:
        keys = list(rewards)
        flags = [done if torch.is_tensor(done) else done[k] for k in keys]
        truncs = [truncated if torch.is_tensor(truncated) else truncated[k] for k in keys]
        outs = gae_module._launch(
            [(rewards[k], values[k], last[k], d, tr) for k, d, tr in zip(keys, flags, truncs)],
            0.95, 0.99, tile_rows=tile_rows)
        got = dict(zip(keys, outs))
    else:
        got = gae_per_key(rewards, values, last, done, truncated, 0.95, 0.99)
    assert gae_cuda.launches == before + 1
    for k in rewards:
        d = done if torch.is_tensor(done) else done[k]
        tr = truncated if torch.is_tensor(truncated) else truncated[k]
        want = gae_scan(rewards[k], values[k], last[k], d, tr, 0.95, 0.99)
        assert torch.equal(got[k], want), f"{k}: max abs error {(got[k] - want).abs().max().item():.3g}"


@pytest.mark.gpu
def test_gae_per_key_reads_column_slices_in_place(cuda):
    """A column slice of wider [T, B] tensors (the contiguous minibatches)
    goes to the kernel at its row stride, with no copy, and gives the bits
    of the contiguous copy."""
    wide = _inputs(20, 2048, seed=3, device=cuda)
    cols = slice(512, 1024)
    sliced = [wide[0][:, cols], wide[1][:, cols], wide[2][cols], wide[3][:, cols], wide[4][:, cols]]
    assert not sliced[0].is_contiguous()
    got = gae_per_key({"a": sliced[0]}, {"a": sliced[1]}, {"a": sliced[2]}, sliced[3], sliced[4],
                      0.95, 0.99)["a"]
    assert torch.equal(got, gae_scan(*(x.contiguous() for x in sliced), 0.95, 0.99))


@pytest.mark.gpu
def test_gae_per_key_refuses_more_than_eight_keys_and_mixed_flag_dtypes(cuda):
    rewards, values, last, done, truncated = _per_key_inputs(5, 64, 9, True, torch.bool, cuda)
    with pytest.raises(ValueError, match="1 to 8 reward keys"):
        gae_per_key(rewards, values, last, done, truncated, 0.95, 0.99)
    eight = [k for k in list(rewards)[:8]]
    sub = [{k: x[k] for k in eight} for x in (rewards, values, last, done, truncated)]
    got = gae_per_key(*sub, 0.95, 0.99)
    assert set(got) == set(eight)
    sub[3]["k1"] = sub[3]["k1"].to(torch.float32)
    with pytest.raises(TypeError):
        gae_per_key(*sub, 0.95, 0.99)
    sub[3]["k1"] = sub[3]["k1"].to(torch.int32)
    with pytest.raises(TypeError):
        gae_per_key(*sub, 0.95, 0.99)


@pytest.mark.gpu
def test_gae_kernel_rejects_wrong_dtype_and_shape(cuda):
    args = _inputs(5, 8, seed=0, device=cuda)
    with pytest.raises(TypeError):
        gae_cuda(args[0].double(), *args[1:], 0.95, 0.99)
    with pytest.raises(ValueError):
        gae_cuda(args[0], args[1][:4], *args[2:], 0.95, 0.99)


def _two_key_quadruped_leg(activation=torch.relu):
    """A quadruped leg with two reward keys ('tracking', 'penalty') and a
    two-headed critic, at a small width."""
    from nnx_ppo_tpu_torch.networks import (
        Concat, Dense, NormalTanhSampler, Parallel, PPOAdapter, Sequential, make_mlp,
    )

    env = EpisodeWrapper(QuadrupedJoystick(reuse_mass_matrix=True, n_substeps=2), max_len=50)
    g = torch.Generator().manual_seed(0)
    enc = Concat.create(proprio=Dense.create(env.observation_size["proprio"], 32, g, activation),
                        command=Dense.create(3, 8, g, activation))
    actor = Sequential.create([Dense.create(40, 2 * env.action_size, g),
                               NormalTanhSampler.create(entropy_weight=1e-3)])
    critic = Parallel.create(
        tracking=make_mlp([40, 16, 1], g, activation, activation_last_layer=False),
        penalty=make_mlp([40, 16, 1], g, activation, activation_last_layer=False))
    return env, Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])


@pytest.mark.gpu
@pytest.mark.parametrize("env_kind", ["cartpole", "quadruped_two_reward_keys"])
def test_ppo_step_launches_the_gae_kernel_once_per_minibatch(cuda, env_kind):
    """One launch per minibatch update for ALL reward keys."""
    if env_kind == "cartpole":
        env = EpisodeWrapper(CartpoleBalance(), max_len=12)
        networks = make_mlp_actor_critic(5, 1, [16, 16], [32], 0)
        config = PPOConfig(n_envs=256, rollout_length=8)
    else:
        env, networks = _two_key_quadruped_leg()
        config = PPOConfig(n_envs=256, rollout_length=8, combine_advantages=True)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(env, networks, 256, seed=0, optimizer=optimizer, device=cuda)
    before = gae_cuda.launches
    ts, metrics = ppo_step(env, ts, config, optimizer)
    assert gae_cuda.launches - before == config.n_epochs * config.n_minibatches
    assert torch.isfinite(metrics["losses/actor/mean"])
    if env_kind != "cartpole":
        assert set(ts.env_states.reward) == {"tracking", "penalty"}
        for key in ("tracking", "penalty"):
            assert torch.isfinite(metrics[f"losses/critic/{key}/mean"])


# The three control-step configurations that chip_smoke.py checks, and
# more: (batch, n_substeps, exact, full feature set). 33 and 1001 envs end
# inside a warp at every group size from 2 to 16 lanes per env.
CONTROL_STEP_CASES = {
    "held_full_2048": (2048, 10, False, True),
    "exact_full_2048": (2048, 10, True, True),
    "flat_ragged_1000": (1000, 10, False, False),
    "one_substep_full_256": (256, 1, False, True),
    "pairs_limits_planes_512": (512, 10, False, "planes"),
    "held_full_ragged_33": (33, 10, False, True),
    "exact_full_ragged_1001": (1001, 10, True, True),
    "held_full_one_env": (1, 10, False, True),
    # legged_training.py's quadruped: exact factor on flat ground, and
    # under --stairs on the staircase (one wave and a slope), no lanes.
    "exact_flat_2048": (2048, 10, True, False),
    "exact_stairs_2048": (2048, 10, True, "stairs"),
}
DR_FIELDS = ("mass_scale", "friction", "damping_scale", "gain_scale")


def control_step_case(name, device):
    B, n_substeps, exact, full = CONTROL_STEP_CASES[name]
    planes, on_stairs = full == "planes", full == "stairs"
    lanes = bool(full) and not on_stairs
    model = make_quadruped(self_collision=planes, joint_limits=planes)
    if on_stairs:
        terrain = stairs(step_height=0.06, step_length=0.4)
    else:
        terrain = rough_terrain(seed=2, amplitude=0.03, wavelength=1.5) if lanes and not planes else None
    plan = ControlStepPlan(
        model, 60.0, 0.002, n_substeps, exact, terrain=terrain,
        dr_fields=DR_FIELDS if lanes else (), has_push=lanes,
        n_terrain_planes=8 if planes else 0,
    )
    arrays = standing_states(
        model, default_qpos(model), B, seed=3, terrain=terrain,
        n_extra_dr=4 if lanes else 0, has_push=lanes,
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
    if lanes:
        args.append(torch.tensor(arrays["extra"], device=device))
    return plan, args


def assert_equal_to_the_bit(got, want):
    for name, g, w in zip(("qpos", "qvel", "normals"), got, want):
        assert torch.equal(g, w), f"{name}: max abs error {(g - w).abs().max().item():.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CONTROL_STEP_CASES))
def test_control_step_kernel_matches_plain_version(cuda, case):
    """float32 on both; each of the kernel's lanes repeats the plain
    version's operations on its scalars in the plain order, without fused
    multiply-adds, and on the card both sides use libdevice's sinf, cosf
    and sqrtf: equal to the bit. (The tolerances stated for a kernel that
    sums in another order would be one substep: qpos 2e-5, qvel 2e-4; ten
    substeps: qpos 2e-4, qvel 2e-3; normals rtol 5e-3 / atol 5e-2, since
    the contact switch phi > 0 and the 6000 N/m stiffness amplify
    rounding.)"""
    plan, args = control_step_case(case, cuda)
    before = control_step_cuda.launches
    got = plan(*args)
    assert control_step_cuda.launches == before + 1
    want = plan.plain(*args)
    want_normals = want[2]
    if args[0].shape[0] > 1:
        assert (want_normals > 0).any() and (want_normals == 0).any()
    if want_normals.shape[1] > 8:
        assert (want_normals[:, 8:] > 0).any()  # a sphere pair touches
    assert_equal_to_the_bit(got, want)


@pytest.mark.gpu
def test_control_step_kernel_rejects_wrong_shapes(cuda):
    plan, args = control_step_case("flat_ragged_1000", cuda)
    with pytest.raises(ValueError):
        plan(args[0], args[1][:, :5], args[2])
    with pytest.raises(ValueError):
        plan(*args, torch.zeros(1000, 7, device=cuda))
    with pytest.raises(ValueError):
        plan.cuda(*(x.cpu() for x in args))


# The humanoid's control-step cases that chip_smoke.py checks: (batch, exact,
# self-collision and joint limits). 11 bodies, nv = 16: one row of the
# forward solve per lane at the shipped 16 lanes per env.
HUMANOID_CASES = {
    "held_8192": (8192, False, False),
    "exact_full_2048": (2048, True, True),
    "held_ragged_33": (33, False, False),
    "exact_full_ragged_1001": (1001, True, True),
}


def humanoid_case(name, device):
    B, exact, full = HUMANOID_CASES[name]
    model = make_humanoid(self_collision=full, joint_limits=full)
    plan = ControlStepPlan(model, 350.0, 0.002, 10, exact)
    arrays = humanoid_states(model, B, seed=3)
    return plan, [torch.tensor(arrays[k], device=device) for k in ("qpos", "qvel", "target")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(HUMANOID_CASES))
def test_control_step_kernel_at_the_humanoids_sizes_matches_plain_version(cuda, case):
    """The humanoid at kp=350 and 12,000 N/m contacts: equal to the bit, as
    the quadruped's cases (the same lane-by-lane operations in the plain
    order; the tolerances stated otherwise would be the quadruped's)."""
    plan, args = humanoid_case(case, cuda)
    before = control_step_cuda.launches
    got = plan(*args)
    assert control_step_cuda.launches == before + 1
    want = plan.plain(*args)
    assert (want[2][:, :6] > 0).any() and (want[2][:, :6] == 0).any()
    if want[2].shape[1] > 6:
        assert (want[2][:, 6:] > 0).any()  # the feet's spheres touch
    assert_equal_to_the_bit(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [False, True], ids=["held", "exact_full"])
def test_humanoid_env_steps_on_the_card_through_the_control_step(cuda, exact):
    env = HumanoidJoystick(reuse_mass_matrix=not exact, self_collision=exact, joint_limits=exact)
    generator = torch.Generator(device=cuda).manual_seed(0)
    state = env.reset(256, generator)
    before = control_step_cuda.launches
    for _ in range(3):
        state = env.step(state, torch.zeros(256, 10, device=cuda), generator)
    assert control_step_cuda.launches == before + 3
    assert state.obs["proprio"].shape == (256, 36) and state.obs["proprio"].is_cuda
    assert torch.isfinite(state.obs["proprio"]).all()
    assert (state.metrics["contact_force"] > 0).any()


# -- the plane sampler and the substeps kernel ---------------------------------

ROUGH = dict(seed=2, amplitude=0.03, wavelength=1.5)
# (batch, table points per side, table half-extent in metres): the
# data-terrain path's own table, and a small one that some of the envs
# (spread over +-5 m) stand outside of.
SAMPLER_CASES = {"2048_on_256": (2048, 256, 12.0), "ragged_1000_partly_outside_32": (1000, 32, 3.0)}


SAMPLER_CASES["ragged_33_on_256"] = (33, 256, 12.0)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [4, 8, 16])
@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_plane_sampler_kernel_matches_plain_version(cuda, case, group):
    """The kernel repeats the plain version's float32 operations in its
    order (the kinematics level by level, each body on one lane;
    reciprocal spacings, x then y, no fused multiply-adds): equal to the
    bit at every number of lanes per env."""
    B, n, extent = SAMPLER_CASES[case]
    model = make_quadruped()
    grid = HeightGrid.sample(rough_terrain(**ROUGH), extent=extent, n=n)
    qpos = torch.tensor(standing_states(model, default_qpos(model), B, seed=5)["qpos"], device=cuda)
    plan = ControlStepPlan(model, 60.0, 0.002, 10, terrain=grid)
    plan.sampler_group = group
    assert plan.sampler_sizes["PS_G"] == group and "CS_G" not in plan.sampler_sizes
    before = plane_sampler_cuda.launches
    got = plan.sample_planes_cuda(qpos)
    assert plane_sampler_cuda.launches == before + 1
    want = plane_sampler_plain(model, grid, qpos)
    assert got.shape == (B, 24) and torch.isfinite(got).all()
    outside = (qpos[:, 0].abs() > extent) | (qpos[:, 1].abs() > extent)
    assert bool(outside.any()) == (extent < 5.0 and B > 100)
    assert (want[:, 1::3].abs() > 1e-3).any()  # real slopes under the feet
    assert torch.equal(got, want)
    if group == 8 and B == 2048:
        # The functional form takes the shipped launch.
        assert torch.equal(plane_sampler_cuda(model, grid, qpos), want)


@pytest.mark.gpu
def test_plane_sampler_and_gae_kernels_keep_no_stack_and_no_spills(cuda):
    model = make_quadruped()
    plan = ControlStepPlan(model, 60.0, 0.002, 10,
                           terrain=HeightGrid.sample(rough_terrain(**ROUGH), extent=12.0, n=256))
    plan.sample_planes_cuda(torch.zeros(1, model.nq, device=cuda))
    gae_per_key(*_per_key_inputs(3, 16, 1, False, torch.bool, cuda), 0.95, 0.99)
    for spec, kernel in ((plan.sampler_spec, "plane_sampler_kernel"), (("gae", ()), "gae_kernel")):
        info = cuda_build.ptxas_info(spec[0], spec[1], kernel)
        assert info["stack_bytes"] <= 64 and info["spill_store_bytes"] == 0, (kernel, info)
        assert info["spill_load_bytes"] == 0, (kernel, info)


@pytest.mark.gpu
def test_heightgrid_runner_launches_sampler_then_control_step(cuda):
    model = make_quadruped()
    terrain = rough_terrain(**ROUGH)
    grid = HeightGrid.sample(terrain, extent=12.0, n=256)
    arrays = standing_states(model, default_qpos(model), 1000, seed=3, terrain=terrain)
    args = [torch.tensor(arrays[k], device=cuda) for k in ("qpos", "qvel", "target")]
    run = make_control_step_runner(model, 60.0, 0.002, 10, terrain=grid)
    before = (plane_sampler_cuda.launches, control_step_cuda.launches)
    got = run(*args)
    assert (plane_sampler_cuda.launches, control_step_cuda.launches) == (before[0] + 1, before[1] + 1)
    # One sampler launch per control step, each on the step's own qpos.
    state = got
    for n in range(2, 4):
        state = run(state[0], state[1], args[2])
        assert (plane_sampler_cuda.launches - before[0], control_step_cuda.launches - before[1]) == (n, n)
    assert torch.isfinite(state[0]).all()
    want = run.plain(*args)
    assert (want[2] > 0).any() and (want[2] == 0).any()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-4)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=2e-3)
    torch.testing.assert_close(got[2], want[2], rtol=5e-3, atol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("per_kernel", [-1, 1, 5])
def test_substeps_kernel_matches_plain_version_on_the_same_factor(cuda, per_kernel):
    """Both sides take the factor built outside, so they agree as the
    control-step kernel and its plain version do: to the bit (the stated
    fallback: ten substeps qpos 2e-4, qvel 2e-3, normals rtol 5e-3 / atol
    5e-2)."""
    B = 2048 if per_kernel == -1 else 1000
    model = make_quadruped(self_collision=True, joint_limits=True)
    arrays = standing_states(model, default_qpos(model), B, seed=3)
    qpos, qvel, target = (torch.tensor(arrays[k], device=cuda) for k in ("qpos", "qvel", "target"))
    chol = mass_matrix_factor(model, qpos, dt=0.002)
    run = make_substep_runner(model, 60.0, 0.002, 10, substeps_per_kernel=per_kernel)
    before = substeps_cuda.launches
    got = run(qpos, qvel, target, chol)
    assert substeps_cuda.launches == before + (1 if per_kernel == -1 else 10 // per_kernel)
    want = substeps_plain(model, qpos, qvel, target, chol, 60.0, 0.002, 10)
    assert (want[2] > 0).any() and (want[2] == 0).any()
    assert_equal_to_the_bit(got, want)
    with pytest.raises(ValueError):
        run(qpos, qvel, target, chol[:, :5])
    with pytest.raises(ValueError):
        substeps_cuda(model, qpos.cpu(), qvel.cpu(), target.cpu(), chol.cpu(), 60.0, 0.002, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["heightgrid", "passed_in_factor"])
def test_new_env_paths_step_on_the_card_through_their_kernels(cuda, path):
    if path == "heightgrid":
        env = QuadrupedJoystick(
            reuse_mass_matrix=True,
            terrain=HeightGrid.sample(rough_terrain(**ROUGH), extent=12.0, n=256),
        )
        counters, per_step = (plane_sampler_cuda, control_step_cuda), (1, 1)
    else:
        env = QuadrupedJoystick(
            reuse_mass_matrix=True, pallas_in_kernel_factor=False, pallas_substeps_per_kernel=5
        )
        counters, per_step = (substeps_cuda, control_step_cuda), (2, 0)
    generator = torch.Generator(device=cuda).manual_seed(0)
    state = env.reset(256, generator)
    before = [c.launches for c in counters]
    state = env.step(state, torch.zeros(256, 12, device=cuda), generator)
    assert [c.launches - b for c, b in zip(counters, before)] == list(per_step)
    assert torch.isfinite(state.obs["proprio"]).all() and state.obs["proprio"].is_cuda
    assert (state.metrics["contact_force"] > 0).any()


# -- the scene control step -----------------------------------------------------

# name -> (batch, n_substeps).
SCENE_CASES = {
    "pusher_4096": (4096, 16),
    "pusher_ragged_1000": (1000, 16),
    "reacher_4096": (4096, 4),
    "general_and_slider_trees_1000": (1000, 3),
    "general_uncapped_on_waves_777": (777, 3),
    "pusher_ragged_33": (33, 16),
    "general_and_slider_trees_ragged_33": (33, 3),
}


def scene_case(name, device):
    """(runner, args on the device) of one scene configuration."""
    B, n_substeps = SCENE_CASES[name]
    if name.startswith("pusher"):
        run = ArmPush(n_substeps=n_substeps)._scene_runner
        arrays = manipulation_states(B, seed=7, with_ball=True, shoulder_height=PUSHER_SHOULDER_HEIGHT)
    elif name.startswith("reacher"):
        run = ArmReacher(n_substeps=n_substeps)._scene_runner
        arrays = manipulation_states(B, seed=8, with_ball=False)
    else:
        waves = "waves" in name
        trees = [general_tree(cap=not waves)] + ([] if waves else [slider_tree()])
        # Cross pairs: the free base against the pole's tip, the cart
        # against the ball-jointed leaf.
        pairs = () if waves else ((0, 0, 1, 0), (1, 1, 0, 2))
        run = make_scene_control_step_runner(
            trees, pairs, 0.002, n_substeps, terrain=rough_terrain(**ROUGH) if waves else None
        )
        parts = [general_tree_states(B, seed=1)] + ([] if waves else [slider_tree_states(B, seed=2)])
        arrays = {k: np.concatenate([p[k] for p in parts], axis=1) for k in ("qpos", "qvel", "tau")}
    return run, [torch.tensor(arrays[k], device=device) for k in ("qpos", "qvel", "tau")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SCENE_CASES))
def test_scene_step_kernel_matches_plain_version(cuda, case):
    """float32 on both; each lane repeats the plain version's operations on
    its scalars in the plain order: equal to the bit. (The stated fallback,
    the tolerances of the JAX lane code against its generic engine: qpos
    2e-5, qvel 5e-4, normals 1e-4.)"""
    run, args = scene_case(case, cuda)
    before = scene_step_cuda.launches
    got = run(*args)
    assert scene_step_cuda.launches == before + 1
    want = run.plain(*args)
    want_normals = want[2]
    assert got[2].shape == (args[0].shape[0], run.n_normals)
    assert all(torch.isfinite(x).all() for x in got)
    if not case.startswith("reacher"):
        assert (want_normals > 0).any() and (want_normals == 0).any()
    if case.startswith("pusher"):
        assert (want_normals[:, 2] > 0).any()  # the cross pair fires
    assert_equal_to_the_bit(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["control_step", "scene_step"])
def test_two_group_sizes_give_the_same_bits(cuda, kernel):
    """The same kernel built for two numbers of lanes per env, launched
    with two block sizes, on a batch that ends inside a warp: the lanes
    share out whole scalars, so the results are the same bits."""
    outs = []
    for group, threads in ((2, 32), (16, 128)) if kernel == "control_step" else ((1, 32), (8, 256)):
        if kernel == "control_step":
            run, args = control_step_case("exact_full_ragged_1001", cuda)
        else:
            run, args = scene_case("general_and_slider_trees_1000", cuda)
            args = [x[:999] for x in args]
        run.group_size, run.threads_per_block = group, threads
        assert run.sizes[("CS_G" if kernel == "control_step" else "SS_G")] == group
        outs.append(run(*args))
    assert_equal_to_the_bit(outs[0], outs[1])


@pytest.mark.gpu
def test_scene_step_kernel_rejects_wrong_shapes_and_devices(cuda):
    run, args = scene_case("reacher_4096", cuda)
    with pytest.raises(ValueError):
        run(args[0], args[1][:, :3], args[2])
    with pytest.raises(ValueError):
        run(args[0], args[1], args[2].cpu())
    with pytest.raises(ValueError):
        run.cuda(*(x.cpu() for x in args))
    # The functional forms agree with the runner.
    got = scene_step_cuda(run.models, run.pairs, *args, run.dt, run.n_substeps)
    want = scene_step_plain(run.models, run.pairs, *args, run.dt, run.n_substeps)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cls", [ArmReacher, ArmPush], ids=["reacher", "pusher"])
def test_manipulation_envs_step_on_the_card_through_the_scene_kernel(cuda, cls):
    env = cls()
    generator = torch.Generator(device=cuda).manual_seed(0)
    state = env.reset(256, generator)
    before = scene_step_cuda.launches
    for _ in range(3):
        state = env.step(state, torch.ones(256, 4, device=cuda))
    assert scene_step_cuda.launches == before + 3
    assert state.obs.is_cuda and torch.isfinite(state.obs).all()
    assert state.obs.shape == (256, env.observation_size)


@pytest.mark.gpu
def test_bf16_dense_on_the_card_matches_the_cpu(cuda):
    """compute_dtype bf16: the float32 product of bf16-rounded operands on
    the card against the CPU. The products are exact on both, so the
    output differs by float32 sum order only: rtol 1e-5 / atol 1e-5 (an
    [in=256] sum of terms near 1). Gradients are rounded to bf16 at the
    operands, where a sum in another order can round to the next bf16
    value, one step (2^-8 to 2^-7 = 7.8e-3 of the value): rtol 8e-3 /
    atol 1e-5."""
    from nnx_ppo_tpu_torch.networks import Dense

    dense = Dense.create(256, 128, torch.Generator().manual_seed(0), torch.relu,
                         compute_dtype=torch.bfloat16)
    x = torch.randn(512, 256, generator=torch.Generator().manual_seed(1))
    w = torch.randn(512, 128, generator=torch.Generator().manual_seed(2))
    grads = {}
    for device in ("cpu", "cuda"):
        layer = Dense(dense.kernel.detach().clone(), dense.bias.detach().clone(), torch.relu,
                      torch.bfloat16).to(device)
        xx = x.detach().to(device).requires_grad_(True)
        out = layer((), xx).output
        (out * w.to(device)).sum().backward()
        grads[device] = (out.detach().cpu(), layer.kernel.grad.cpu(), xx.grad.cpu())
    torch.testing.assert_close(grads["cuda"][0], grads["cpu"][0], rtol=1e-5, atol=1e-5)
    for got, want in zip(grads["cuda"][1:], grads["cpu"][1:]):
        torch.testing.assert_close(got, want, rtol=8e-3, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_recurrent_replay_on_the_card_matches_the_cpu(cuda, cell):
    """The hoisted GRU / LSTM replay with resets, trainable initial
    state, on the card against the CPU: outputs rtol 1e-5 / atol 1e-5,
    gradients rtol 1e-4 / atol 1e-5 (float32, matmuls reduced in another
    order; TF32 off)."""
    from nnx_ppo_tpu_torch.networks import GRU, LSTM

    cls = {"gru": GRU, "lstm": LSTM}[cell]
    module = cls.create(5, 64, torch.Generator().manual_seed(0), trainable_initial_state=True)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    g = torch.Generator().manual_seed(4)
    T, B = 30, 256
    obs = torch.randn(T, B, 5, generator=g)
    done = torch.rand(T, B, generator=g) < 0.05
    results = {}
    for device in ("cpu", "cuda"):
        m = cls(*[p.detach().clone() for p in module.parameters()]).to(device)
        state = m.initialize_state(B)
        out, _, final = m.replay_sequence(state, obs.to(device), done.to(device), None)
        h = final[0] if cell == "lstm" else final
        (out.square().sum() + h.sum()).backward()
        results[device] = (out.detach().cpu(), [p.grad.cpu() for p in m.parameters()])
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-5, atol=1e-5)
    for got, want in zip(results["cuda"][1], results["cpu"][1]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# Batch-major GAE: (T, B, keys, flag dtype, row stride or None): the
# bf16-store path's minibatch [b=512, T=20] x 2, the flagship's [256, 30],
# a ragged b=33, and rows of a wider [B, 32] buffer (per-env segments).
GAE_BATCH_MAJOR_CASES = {
    "quadruped_512x20_two_keys": (20, 512, 2, torch.bool, None),
    "flagship_256x30": (30, 256, 1, torch.bool, None),
    "ragged_33x20_two_keys": (20, 33, 2, torch.bool, None),
    "float_flags_rows_of_32": (30, 100, 1, torch.float32, 32),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GAE_BATCH_MAJOR_CASES))
def test_batch_major_gae_reads_b_t_keys_in_place_equal_to_gae_scan(cuda, case):
    """gae_per_key(batch_major=True) on [B, T] keys: one launch, no copy of
    the inputs, [B, T] advantages equal to the bit to gae_scan on the
    transposed views."""
    T, B, n_keys, flag_dtype, ld = GAE_BATCH_MAJOR_CASES[case]
    width = ld or T
    rewards, values, last, done, truncated = (
        {k: x.T.contiguous() if x.ndim == 2 else x for k, x in tree.items()}
        if isinstance(tree, dict) else tree.T.contiguous()
        for tree in _per_key_inputs(width, B, n_keys, False, flag_dtype, cuda))
    if ld:
        rewards, values = ({k: x[:, :T] for k, x in t.items()} for t in (rewards, values))
        done, truncated = done[:, :T], truncated[:, :T]
        assert not done.is_contiguous()
    before = gae_cuda.launches
    got = gae_per_key(rewards, values, last, done, truncated, 0.95, 0.99, batch_major=True)
    assert gae_cuda.launches == before + 1
    for k in rewards:
        want = gae_scan(rewards[k].T, values[k].T, last[k], done.T, truncated.T, 0.95, 0.99).T
        assert got[k].shape == (B, T) and got[k].is_contiguous()
        assert torch.equal(got[k], want), f"{k}: max abs error {(got[k] - want).abs().max().item():.3g}"


def _loss_on_card_and_cpu(loss_fn, net, view, state):
    """loss_fn(net, state, view) and its gradients on the card and on a
    CPU copy."""
    import copy

    from nnx_ppo_tpu_torch.core.struct import tree_map

    results = []
    for device in ("cuda", "cpu"):
        m = copy.deepcopy(net).to(device)
        on = lambda tree: tree_map(lambda x: x.to(device) if torch.is_tensor(x) else x, tree)
        loss = loss_fn(m, on(state), on(view))
        loss.backward()
        results.append((loss.item(), [torch.zeros_like(p).cpu() if p.grad is None else p.grad.cpu()
                                      for p in m.parameters()]))
    return results


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["bf16_store", "distillation"])
def test_new_paths_loss_on_the_card_matches_the_cpu(cuda, path):
    """The bf16-store PPO loss and the distillation loss of a batch-major
    minibatch of the flat quadruped (64 envs, T=8, the control-step
    kernel in the rollout) on the card against the CPU: loss rtol 1e-4 /
    atol 1e-5 (chip_smoke.py's float32 limit); gradients rtol 1e-3 and
    an atol of 1e-5 plus 1e-4 of each tensor's largest entry: float32
    sums over T·B samples in another order move an entry near zero by a
    share of the summands' size, not of its own (4.4e-5 on one entry of
    the actor head here; up to 9e-6 of a tensor's largest entry in
    chip_smoke.py's references on the H100). The net's hidden layers are
    tanh: with relu this loss is ill-conditioned in float32 itself at 512
    samples, without any relu input changing sign between the devices:
    against float64 on the CPU, float32 on the card and on the CPU each
    read 2.9e-4 to 1.6e-3 of a tensor's largest entry with relu, 1.2e-6
    to 1.7e-6 with tanh (H100, two seeds each). The student of the
    distillation loss is the teacher shifted by 0.01·sign(sin(arange)),
    as in distill_quadruped_2048: with the two equal, the target is the
    student's own mean and its gradient only rounding noise."""
    from nnx_ppo_tpu_torch.algorithms import (
        DistillationConfig, LoggingLevel, distillation_loss, ppo_loss, resolve_batch_major,
    )
    from nnx_ppo_tpu_torch.algorithms.distillation import (
        DistillationMinibatch, distillation_unroll_env,
    )
    from nnx_ppo_tpu_torch.algorithms.ppo import ReplayMinibatch
    from nnx_ppo_tpu_torch.algorithms.rollout import unroll_env

    env, net = _two_key_quadruped_leg(torch.tanh)
    net = net.to(cuda)
    assert resolve_batch_major(PPOConfig(), net)
    g = torch.Generator(device=cuda).manual_seed(0)
    B, T = 64, 8
    env_state = env.reset(B, g)
    state = net.initialize_state(B)
    before = control_step_cuda.launches
    with torch.no_grad():
        if path == "bf16_store":
            _, _, rollout_data = unroll_env(env, env_state, net, state, T, g)
            view = ReplayMinibatch.from_rollout(rollout_data, True, torch.bfloat16)
            assert view.obs["proprio"].dtype == torch.bfloat16

            def loss_fn(m, s, v):
                return ppo_loss(m, s, v, clip_range=0.2, normalize_advantages=True,
                                combine_advantages=True, discounting_factor=0.99,
                                gae_lambda=0.95, critic_loss_weight=1.0,
                                logging_level=LoggingLevel.NONE)[0]
        else:
            teacher = _two_key_quadruped_leg(torch.tanh)[1].to(cuda).eval()
            for p in net.parameters():
                shift = torch.sign(torch.sin(torch.arange(p.numel(), dtype=torch.float32)))
                p.add_(0.01 * shift.reshape(p.shape).to(cuda))
            _, _, _, rollout_data = distillation_unroll_env(env, env_state, teacher, net, state,
                                                            teacher.initialize_state(B), T, g)
            assert resolve_batch_major(DistillationConfig(), net)
            view = DistillationMinibatch.from_rollout(rollout_data, True)

            def loss_fn(m, s, v):
                return distillation_loss(m, s, v, LoggingLevel.NONE)[0]
    assert control_step_cuda.launches == before + T
    (loss_gpu, grads_gpu), (loss_cpu, grads_cpu) = _loss_on_card_and_cpu(loss_fn, net, view, state)
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-4, atol=1e-5)
    for got, want in zip(grads_gpu, grads_cpu):
        torch.testing.assert_close(got, want, rtol=1e-3,
                                   atol=1e-5 + 1e-4 * want.abs().max().item())


# -- the MJCF quadruped and the generic engine on the card ----------------------


MJCF_QUADRUPED_CASES = {"held_2048": 2048, "held_ragged_33": 33}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(MJCF_QUADRUPED_CASES))
def test_control_step_kernel_at_the_mjcf_quadrupeds_sizes_matches_plain_version(cuda, case):
    """The control step built at the imported MJCF quadruped's sizes (13
    bodies, 4 ground geoms where the native quadruped has 8), from the
    saved import: equal to the bit, as every other model's."""
    from nnx_ppo_tpu_torch.physics.models import mjcf_quadruped

    B = MJCF_QUADRUPED_CASES[case]
    env = mjcf_quadruped.make_env(reuse_mass_matrix=True)
    plan = ControlStepPlan(env.model, env.kp, 0.002, 10, False)
    pose = np.concatenate([[0.0, 0.0, mjcf_quadruped.STAND_HEIGHT, 1.0, 0.0, 0.0, 0.0],
                           mjcf_quadruped.DEFAULT_POSE])
    arrays = standing_states(env.model, pose, B, seed=3)
    args = [torch.tensor(arrays[k], device=cuda) for k in ("qpos", "qvel", "target")]
    before = control_step_cuda.launches
    got = plan(*args)
    assert control_step_cuda.launches == before + 1
    want = plan.plain(*args)
    assert (want[2] > 0).any() and (want[2] == 0).any()
    assert_equal_to_the_bit(got, want)


def _legged_pair(kind):
    """(kernel env, generic env) of one legged configuration: the physics
    leg's quadruped (randomization, pushes, rough terrain) or the MJCF
    quadruped, both with the held factor."""
    from nnx_ppo_tpu_torch.physics import DomainRandomization
    from nnx_ppo_tpu_torch.physics.models import mjcf_quadruped

    def make(impl):
        if kind == "mjcf_quadruped":
            return mjcf_quadruped.make_env(reuse_mass_matrix=True, substep_impl=impl)
        return QuadrupedJoystick(
            reuse_mass_matrix=True, push_prob=0.02, push_force=50.0, terrain=rough_terrain(**ROUGH),
            randomize=DomainRandomization(mass_scale=(0.8, 1.2), friction=(0.4, 1.0),
                                          damping_scale=(0.9, 1.1), gain_scale=(0.9, 1.1)),
            substep_impl=impl,
        )

    return make("pallas"), make("xla")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["quadruped_physics_leg", "mjcf_quadruped"])
def test_control_step_kernel_matches_the_generic_engine(cuda, kind):
    """One control step of ten substeps through the kernel against the
    generic engine on the card, from the same state, action and draws: qpos
    rtol / atol 2e-4, qvel 2e-3, the tolerances of the JAX package's check
    of its kernel against its generic engine (tests/test_physics_soa.py:
    79-82); foot contact force rtol 5e-3 / atol 5e-2."""
    kernel_env, generic_env = _legged_pair(kind)
    B = 256
    g = torch.Generator(device=cuda).manual_seed(13)
    state = kernel_env.reset(B, g)
    action = 2.4 * torch.rand((B, kernel_env.action_size), generator=g, device=cuda) - 1.2
    push = None
    if kernel_env.push_force > 0.0:
        push = (torch.arange(B, device=cuda) % 4 == 0, kernel_env._draw_push(B, g)[1])
    resample = kernel_env._draw_resample(B, g)
    before = control_step_cuda.launches
    got = kernel_env._step_from(state, action, push, resample, None)
    assert control_step_cuda.launches == before + 1
    want = generic_env._step_from(state, action, push, resample, None)
    assert control_step_cuda.launches == before + 1
    assert (want.metrics["contact_force"] > 0).any()
    torch.testing.assert_close(got.data["qpos"], want.data["qpos"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got.data["qvel"], want.data["qvel"], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got.metrics["contact_force"], want.metrics["contact_force"],
                               rtol=5e-3, atol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("cls", [ArmReacher, ArmPush], ids=["reacher", "pusher"])
def test_scene_kernel_matches_the_generic_engine(cuda, cls):
    """One control step of the scene kernel against engine.step (reacher)
    or scene_step (pusher) on the card: qpos rtol / atol 2e-5, qvel 2e-4,
    normals 1e-4 (tests/test_soa_general.py:81-87); the pusher's generic
    step returns its cross pair's normals only."""
    from nnx_ppo_tpu_torch.physics.engine import step
    from nnx_ppo_tpu_torch.physics.scene import scene_step

    env = cls()
    pusher = cls is ArmPush
    run = env._scene_runner
    arrays = manipulation_states(512, seed=14, with_ball=pusher,
                                 shoulder_height=PUSHER_SHOULDER_HEIGHT if pusher else 1.0)
    qpos, qvel, tau = (torch.tensor(arrays[k], device=cuda) for k in ("qpos", "qvel", "tau"))
    got = run.cuda(qpos, qvel, tau)
    if pusher:
        arm = env.scene.models[0]
        split = lambda x, n: (x[:, :n], x[:, n:])
        qps, qvs, cross = scene_step(env.scene, split(qpos, arm.nq), split(qvel, arm.nv),
                                     split(tau, arm.nv), run.dt, run.n_substeps)
        want = (torch.cat(qps, dim=-1), torch.cat(qvs, dim=-1), cross)
        got = (got[0], got[1], got[2][:, -1:])
        assert (cross > 0).any() and (cross == 0).any()
    else:
        want = step(env.model, qpos, qvel, tau, run.dt, run.n_substeps)
    for (name, tol), g, w in zip((("qpos", 2e-5), ("qvel", 2e-4), ("normals", 1e-4)), got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("tree", ["general_tree", "slider_tree"])
def test_generic_engine_on_the_card_matches_the_cpu(cuda, tree):
    """forward_dynamics on a tree with slide and ball joints (and a free or
    a slide root) on the card against the CPU: rtol 1e-5, atol 1e-5 times
    the largest entry, the engine's CPU parity tolerance with the JAX
    package (tests/test_torch_generic_engine.py)."""
    from nnx_ppo_tpu_torch.physics.engine import forward_dynamics

    model, arrays = ((general_tree(), general_tree_states(256, seed=9)) if tree == "general_tree"
                     else (slider_tree(), slider_tree_states(256, seed=10)))
    cpu = [torch.tensor(arrays[k]) for k in ("qpos", "qvel", "tau")]
    want = forward_dynamics(model, *cpu, dt=0.002)
    got = forward_dynamics(model, *(x.to(cuda) for x in cpu), dt=0.002)
    for g, w in zip(got, want):
        assert g.is_cuda
        scale = max(1.0, w.abs().max().item())
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["quadruped", "reacher", "pusher"])
def test_generic_env_steps_on_the_card_launch_no_physics_kernel(cuda, kind):
    """substep_impl="xla" on the card: eager PyTorch, no control-step or
    scene kernel; the step equals the CPU's within the env tolerances
    (qpos 2e-4, qvel 2e-3)."""
    env = {"quadruped": lambda: QuadrupedJoystick(reuse_mass_matrix=True, substep_impl="xla"),
           "reacher": lambda: ArmReacher(substep_impl="xla"),
           "pusher": lambda: ArmPush(substep_impl="xla")}[kind]()
    g = torch.Generator(device=cuda).manual_seed(0)
    state = env.reset(128, g)
    action = torch.full((128, env.action_size), 0.5, device=cuda)
    before = (control_step_cuda.launches, scene_step_cuda.launches)
    on_card = env.step(state, action, torch.Generator(device=cuda).manual_seed(1))
    assert (control_step_cuda.launches, scene_step_cuda.launches) == before
    from nnx_ppo_tpu_torch.core.struct import tree_map

    cpu_state = tree_map(lambda x: x.cpu(), state)
    if kind == "quadruped":
        draws = env._draw_resample(128, torch.Generator(device=cuda).manual_seed(1))
        on_card = env._step_from(state, action, None, draws, None)
        on_cpu = env._step_from(cpu_state, action.cpu(), None, tree_map(lambda x: x.cpu(), draws),
                                None)
    else:
        on_cpu = env.step(cpu_state, action.cpu())
    for key, value in on_cpu.data.items():
        if isinstance(value, torch.Tensor):
            atol = 2e-3 if "qvel" in key else 2e-4
            torch.testing.assert_close(on_card.data[key].cpu(), value, rtol=0, atol=atol, msg=key)


def _one_env_case(kind, device):
    """(kernel call, plain call, launch counters) of one kernel at a batch
    of one env, the batch of the video's render rollout: a lane-group
    block with one env and 7 (control step, 8 envs per 128 threads) or 15
    (scene, 16 per 64) empty env slots, whose lanes still reach every
    barrier."""
    if kind.startswith("control_step"):
        plan, args = control_step_case("exact_full_ragged_1001" if kind.endswith("exact")
                                       else "held_full_ragged_33", device)
        args = [a[:1].contiguous() for a in args]
        return lambda: plan(*args), lambda: plan.plain(*args), (control_step_cuda,)
    if kind in ("plane_sampler", "control_step_on_planes"):
        model = make_quadruped()
        grid = HeightGrid.sample(rough_terrain(**ROUGH), extent=12.0, n=256)
        arrays = standing_states(model, default_qpos(model), 1, seed=5,
                                 terrain=rough_terrain(**ROUGH))
        args = [torch.tensor(arrays[k], device=device) for k in ("qpos", "qvel", "target")]
        plan = ControlStepPlan(model, 60.0, 0.002, 10, terrain=grid)
        if kind == "plane_sampler":
            return (lambda: (plan.sample_planes_cuda(args[0]),),
                    lambda: (plane_sampler_plain(model, grid, args[0]),), (plane_sampler_cuda,))
        run = make_control_step_runner(model, 60.0, 0.002, 10, terrain=grid)
        return (lambda: run(*args), lambda: run.plain(*args),
                (plane_sampler_cuda, control_step_cuda))
    if kind == "substeps":
        model = make_quadruped()
        arrays = standing_states(model, default_qpos(model), 1, seed=3)
        qpos, qvel, target = (torch.tensor(arrays[k], device=device)
                              for k in ("qpos", "qvel", "target"))
        chol = mass_matrix_factor(model, qpos, dt=0.002)
        run = make_substep_runner(model, 60.0, 0.002, 10, substeps_per_kernel=-1)
        return (lambda: run(qpos, qvel, target, chol),
                lambda: substeps_plain(model, qpos, qvel, target, chol, 60.0, 0.002, 10),
                (substeps_cuda,))
    run, args = scene_case("pusher_ragged_33" if kind == "scene_pusher" else "reacher_4096",
                           device)
    args = [a[:1].contiguous() for a in args]
    return lambda: run(*args), lambda: run.plain(*args), (scene_step_cuda,)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["control_step_held", "control_step_exact",
                                  "control_step_on_planes", "plane_sampler", "substeps",
                                  "scene_pusher", "scene_reacher"])
def test_kernels_at_one_env_match_plain_version(cuda, kind):
    """Each physics kernel launched for one env equals its plain version
    to the bit, as at 33 envs and more: the empty env slots of its block
    write nothing and leave no barrier short."""
    run, plain, counters = _one_env_case(kind, cuda)
    before = [c.launches for c in counters]
    got = run()
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    want = plain()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape[0] == 1 and torch.isfinite(g).all()
        assert torch.equal(g, w), f"max abs error {(g - w).abs().max().item():.3g}"


@pytest.mark.gpu
def test_a_resumed_run_on_the_card_follows_the_uninterrupted_one(cuda, tmp_path):
    """train_ppo on the card, 4 iterations, against 2, a checkpoint, a
    load into a fresh template and 2 more: equal to the bit where two
    uninterrupted runs are (else no further apart than they are from
    each other)."""
    from nnx_ppo_tpu_torch.algorithms import (
        EvalConfig, TrainConfig, load_checkpoint, make_checkpoint_fn, train_ppo,
    )

    env = EpisodeWrapper(CartpoleBalance(), 50)
    net = make_mlp_actor_critic(5, 1, [32, 32], [64], 0, normalize_obs=True)
    ppo = PPOConfig(n_envs=64, rollout_length=8, n_epochs=2, n_minibatches=4, anneal_lr=True,
                    total_steps=4 * 64 * 8)
    cfg = TrainConfig(ppo=ppo, eval=EvalConfig(enabled=False), checkpoint_every_steps=2 * 64 * 8)
    runs = [train_ppo(env, net, cfg, device="cuda",
                      checkpoint_fn=make_checkpoint_fn(str(tmp_path / f"run{i}")))
            for i in range(2)]
    template = new_training_state(env, net, 64, seed=7, device="cuda")
    restored = load_checkpoint(str(tmp_path / "run0" / f"step_{2 * 64 * 8:010d}"), template)
    resumed = train_ppo(env, net, cfg, initial_state=restored["training_state"], device="cuda")

    def leaves(res):
        ts = res.training_state
        return [ts.networks.state_dict()[k] for k in ts.networks.state_dict()] + [
            ts.env_states.obs, ts.generator.get_state()]

    a, b, r = (leaves(x) for x in (*runs, resumed))
    spread = max((x.double() - y.double()).abs().max().item() for x, y in zip(a, b))
    gap = max((x.double() - y.double()).abs().max().item() for x, y in zip(a, r))
    assert gap <= spread, (gap, spread)
    if spread == 0:
        assert all(torch.equal(x, y) for x, y in zip(a, r))


# -- the depth-wise engine and world size 1 (data parallelism) ---------------


def _dw_states(model, default, B, device):
    rng = np.random.RandomState(41)
    qpos = np.tile(default(model), (B, 1)).astype(np.float32)
    qpos[:, 7:] += 0.2 * rng.randn(B, model.nj).astype(np.float32)
    qpos[:, 2] += 0.05 * rng.randn(B).astype(np.float32)
    qvel = (0.5 * rng.randn(B, model.nv)).astype(np.float32)
    tau = np.concatenate([np.zeros((B, 6)), 2.0 * rng.randn(B, model.nj)], -1)
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in (qpos, qvel, tau)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["quadruped", "humanoid"])
def test_depthwise_engine_matches_the_generic_one_on_the_card(cuda, kind):
    """forward_dynamics_dw on the card against the generic engine on the
    card at 1024 envs: qacc and normals within the JAX package's rtol
    2e-4 / atol 2e-3 (tests/test_physics_depthwise.py:39-62); and, with
    the held inverse, within 5e-4 / 5e-3 of the held factor."""
    from nnx_ppo_tpu_torch.physics import (
        DepthPlan, forward_dynamics, forward_dynamics_dw, mass_matrix_factor_dw,
        mass_matrix_inverse_dw,
    )
    from nnx_ppo_tpu_torch.physics.models import humanoid as hu

    model = make_quadruped() if kind == "quadruped" else make_humanoid()
    args = _dw_states(model, default_qpos if kind == "quadruped" else hu.default_qpos, 1024, cuda)
    plan = DepthPlan.build(model)
    got = forward_dynamics_dw(model, plan, *args, dt=0.002)
    want = forward_dynamics(model, *args, dt=0.002)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-3)
    held = forward_dynamics_dw(model, plan, *args, dt=0.002,
                               chol=mass_matrix_factor_dw(model, plan, args[0], dt=0.002))[0]
    inverse = forward_dynamics_dw(model, plan, *args, dt=0.002,
                                  minv=mass_matrix_inverse_dw(model, plan, args[0], dt=0.002))[0]
    torch.testing.assert_close(inverse, held, rtol=5e-4, atol=5e-3)


@pytest.mark.gpu
def test_two_depthwise_runs_on_the_card_are_equal_to_the_bit(cuda):
    """The quadruped on the depth-wise engine (substep_impl="xla", held
    inverse, randomization, pushes, rough terrain), two control steps of
    256 envs from one seed, twice: equal to the bit (the upward sums are
    fixed gathers, no atomics)."""
    from nnx_ppo_tpu_torch.physics import DomainRandomization

    def run():
        env = QuadrupedJoystick(reuse_mass_matrix=True, substep_impl="xla",
                                randomize=DomainRandomization(), push_prob=0.5,
                                push_force=50.0, terrain=rough_terrain(seed=2, amplitude=0.03))
        assert env._plan is not None
        g = torch.Generator(device=cuda).manual_seed(3)
        state = env.reset(256, g)
        for _ in range(2):
            state = env.step(state, torch.rand((256, 12), generator=g, device=cuda) * 2 - 1, g)
        return state.data

    a, b = run(), run()
    for key in ("qpos", "qvel"):
        assert torch.equal(a[key], b[key]), key


@pytest.mark.gpu
def test_world_size_1_on_nccl_equals_the_run_without_a_mesh(cuda, tmp_path):
    """ppo_step with make_mesh() at world size 1 on NCCL (every collective
    runs, over one rank) equals the step without a mesh to the bit, two
    steps of the flagship-shaped config at 256 envs."""
    import torch.distributed as dist

    from nnx_ppo_tpu_torch.parallel import distributed_initialize, make_mesh

    def run(mesh):
        env = EpisodeWrapper(CartpoleBalance(), 500)
        net = make_mlp_actor_critic(5, 1, [64] * 2, [256], 0, normalize_obs=True)
        cfg = PPOConfig(n_envs=256, rollout_length=16, n_epochs=2, n_minibatches=4)
        opt = make_optimizer(cfg.learning_rate)
        ts = new_training_state(env, net, 256, seed=0, optimizer=opt,
                                device=None if mesh else cuda, mesh=mesh)
        for _ in range(2):
            ts, metrics = ppo_step(env, ts, cfg, opt, mesh)
        return ts, metrics

    assert not dist.is_initialized()
    distributed_initialize(backend="nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                           rank=0, world_size=1)
    try:
        got, got_metrics = run(make_mesh())
    finally:
        dist.destroy_process_group()
    want, want_metrics = run(None)
    for (name, a), b in zip(got.networks.state_dict().items(), want.networks.state_dict().values()):
        assert torch.equal(a, b), name
    for key in want_metrics:
        assert torch.equal(torch.as_tensor(got_metrics[key]), torch.as_tensor(want_metrics[key])), key
    assert torch.equal(got.env_states.obs, want.env_states.obs)


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA devices, {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.gpu
def test_a_launch_on_another_card_leaves_the_current_device(two_cards):
    """The kernels' entry points set the calling thread's device to the
    tensors'; the wrappers give the caller's current device back. GAE and
    the control step launched on card 1 from a process whose current card
    is 0: their outputs on card 1, equal to the plain version there, each
    launch counted on card 1, and card 0 still current."""
    first, second = two_cards
    torch.cuda.set_device(first)
    before = gae_cuda.devices[1], control_step_cuda.devices[1]
    args = _inputs(20, 512, 0, second)
    got = gae_cuda(*args, 0.95, 0.99)
    assert torch.cuda.current_device() == 0
    assert got.device == second and torch.equal(got, gae_scan(*args, 0.95, 0.99))
    model = make_quadruped()
    plan = ControlStepPlan(model, 60.0, 0.002, 10, False)
    arrays = standing_states(model, default_qpos(model), 64, seed=3)
    states = [torch.tensor(arrays[k], device=second) for k in ("qpos", "qvel", "target")]
    out = plan.cuda(*states)
    assert torch.cuda.current_device() == 0
    want = plan.plain(*states)
    for g, w in zip(out, want):
        assert g.device == second and torch.equal(g, w)
    assert (gae_cuda.devices[1], control_step_cuda.devices[1]) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_make_mesh_makes_the_ranks_card_current(two_cards, tmp_path, monkeypatch):
    """A one-process NCCL group started as local rank 1: the mesh's device
    is card 1, card 1 is current, and a bare ``"cuda"`` resolves to it (a
    state built on ``device="cuda"`` under the mesh is accepted)."""
    import torch.distributed as dist

    from nnx_ppo_tpu_torch.core.device import resolve_device
    from nnx_ppo_tpu_torch.parallel import distributed_initialize, make_mesh

    _, second = two_cards
    monkeypatch.setenv("LOCAL_RANK", "1")
    previous = torch.cuda.current_device()
    distributed_initialize(backend="nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                           rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.device == second and torch.cuda.current_device() == 1
        assert resolve_device("cuda") == second
        env = EpisodeWrapper(CartpoleBalance(), 500)
        net = make_mlp_actor_critic(5, 1, [16], [16], 0)
        ts = new_training_state(env, net, 8, seed=0, device="cuda", mesh=mesh)
        assert ts.generator.device == second and ts.env_states.obs.device == second
    finally:
        dist.destroy_process_group()
        torch.cuda.set_device(previous)
