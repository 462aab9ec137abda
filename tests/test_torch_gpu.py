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
from nnx_ppo_tpu_torch.ops import cuda_build
from nnx_ppo_tpu_torch.ops import gae as gae_module
from nnx_ppo_tpu_torch.ops.gae import gae, gae_cuda, gae_per_key, gae_scan
from nnx_ppo_tpu_torch.envs import ArmPush, ArmReacher, QuadrupedJoystick
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
from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid, rough_terrain
from nnx_ppo_tpu_torch.physics.testing import (
    general_tree,
    general_tree_states,
    manipulation_states,
    slider_tree,
    slider_tree_states,
    standing_states,
)
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


def _two_key_quadruped_leg():
    """A quadruped leg with two reward keys ('tracking', 'penalty') and a
    two-headed critic, at a small width."""
    from nnx_ppo_tpu_torch.networks import (
        Concat, Dense, NormalTanhSampler, Parallel, PPOAdapter, Sequential, make_mlp,
    )

    env = EpisodeWrapper(QuadrupedJoystick(reuse_mass_matrix=True, n_substeps=2), max_len=50)
    g = torch.Generator().manual_seed(0)
    enc = Concat.create(proprio=Dense.create(env.observation_size["proprio"], 32, g, torch.relu),
                        command=Dense.create(3, 8, g, torch.relu))
    actor = Sequential.create([Dense.create(40, 2 * env.action_size, g),
                               NormalTanhSampler.create(entropy_weight=1e-3)])
    critic = Parallel.create(tracking=make_mlp([40, 16, 1], g, activation_last_layer=False),
                             penalty=make_mlp([40, 16, 1], g, activation_last_layer=False))
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
