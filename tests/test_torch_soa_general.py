"""General-tree SoA dynamics and the scene control step: the port's
plain versions against the JAX package on the same numpy inputs.

* ``engine_soa_general.py`` of the port against the JAX lane functions on
  ``[B]`` arrays (eager, no jit): the same float32 operations in the same
  order, so what is left is ``sin``/``cos``/``sqrt`` of XLA's CPU backend
  against PyTorch's (a few ulp): rtol 1e-5 / atol 1e-6, contact forces
  (thousands of N/m times a rounded depth) rtol 1e-5 / atol 1e-4.
* ``scene_step_plain`` and the runner on CPU tensors against the generic
  JAX engine (``engine.step``, ``scene.scene_step``: 6x6 matrix algebra,
  another order of operations) at the tolerances of the JAX package's own
  ``tests/test_soa_general.py``: qpos 2e-5, qvel 2e-4 (5e-4 through the
  cross contact), normals 1e-4; and against the Pallas kernel itself in
  interpret mode with one tile.
* the wrapper as far as the CPU reaches: normals order, the one zero
  column of a scene without contacts, the packed scene struct, refusals.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.envs.pusher import _make_ball as jax_make_ball
from nnx_ppo_tpu.physics import engine_soa_general as jax_general
from nnx_ppo_tpu.physics import model as jax_model
from nnx_ppo_tpu.physics import terrain as jax_terrain
from nnx_ppo_tpu.physics.engine import step as jax_engine_step
from nnx_ppo_tpu.physics.models.arm import make_arm as jax_make_arm
from nnx_ppo_tpu.physics.pallas_step import pallas_scene_step
from nnx_ppo_tpu.physics.scene import Scene as JaxScene
from nnx_ppo_tpu.physics.scene import scene_step as jax_scene_step
from nnx_ppo_tpu_torch.envs.pusher import _make_ball
from nnx_ppo_tpu_torch.physics import Scene, engine_soa_general, model, terrain
from nnx_ppo_tpu_torch.physics import scene as scene_module
from nnx_ppo_tpu_torch.physics.cuda_scene_step import (
    SIZE_NAMES,
    SceneStepPlan,
    make_scene_control_step_runner,
    pack_scene_params,
    scene_step_cuda,
    scene_step_plain,
)
from nnx_ppo_tpu_torch.physics.models import arm as arm_module
from nnx_ppo_tpu_torch.physics.models.arm import make_arm
from nnx_ppo_tpu_torch.physics.testing import (
    general_tree,
    general_tree_states,
    slider_tree,
    slider_tree_states,
)

torch.set_num_threads(1)

B = 8
DT = 0.00125
CONTACT = dict(contact_stiffness=3000.0, contact_damping=50.0, friction=0.6, friction_vel=1.0,
               max_contact_force=80.0)
ROUGH = dict(seed=2, amplitude=0.03, wavelength=1.5)


def unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def f32(*parts):
    return np.concatenate(parts, axis=1).astype(np.float32)


def jax_lanes(x):
    return tuple(jnp.asarray(x[:, k]) for k in range(x.shape[1]))


def torch_lanes(x):
    return tuple(torch.from_numpy(x).unbind(1))


def stacked(lanes):
    return np.stack([np.asarray(x) for x in lanes], axis=1)


def arm_states(rng, n=B):
    """Random shoulder orientation, elbow angle (some beyond the +-2.6
    stop), velocities and torques of the arm."""
    qpos = f32(unit(rng.randn(n, 4)), 1.5 * rng.randn(n, 1))
    return qpos, f32(0.5 * rng.randn(n, 4)), f32(1.5 * rng.randn(n, 4))


def ball_states(rng, n=B):
    """The free ball near the ground (some touching), spinning."""
    qpos = f32(0.25 * rng.randn(n, 2), 0.05 + 0.2 * rng.rand(n, 1), unit(rng.randn(n, 4)))
    return qpos, f32(rng.randn(n, 6)), np.zeros((n, 6), np.float32)


def pusher_states(rng, n=B):
    """Arm + ball with the cross pair firing: env 0 hangs at rest with the
    ball 0.09 m below the end effector (inside the 0.11 m contact shell),
    as in the JAX package's own scene test."""
    aq, av, at = arm_states(rng, n)
    bq, bv, bt = ball_states(rng, n)
    aq[0] = [1, 0, 0, 0, 0]
    av[0] = 0.0
    bq[0] = [0, 0, 1.0 - 0.65 - 0.09, 1, 0, 0, 0]
    bv[0] = 0.0
    return (aq, bq), (av, bv), (at, bt)


def general_states(rng, n=B):
    s = general_tree_states(n, rng.randint(1 << 30))
    return s["qpos"], s["qvel"], s["tau"]


def slider_states(rng, n=B):
    s = slider_tree_states(n, rng.randint(1 << 30))
    return s["qpos"], s["qvel"], s["tau"]


# -- the model ------------------------------------------------------------------


def test_arm_model_fields_match_jax():
    jm, tm = jax_make_arm(shoulder_height=0.55, **CONTACT), make_arm(shoulder_height=0.55, **CONTACT)
    for field in dataclasses.fields(tm):
        a, b = getattr(jm, field.name), getattr(tm, field.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=field.name)
        else:
            assert a == b, field.name
    assert (tm.nq, tm.nv, tm.joint_type) == (5, 4, ("ball", "hinge"))
    np.testing.assert_array_equal(arm_module.default_qpos(tm), [1, 0, 0, 0, 0])
    assert (arm_module.UPPER_LEN, arm_module.FORE_LEN, arm_module.SHOULDER_HEIGHT) == (0.35, 0.3, 1.0)
    np.testing.assert_array_equal(arm_module.EE_OFFSET, [0, 0, -0.3])
    ball = _make_ball()
    assert (ball.nq, ball.nv, ball.max_contact_force) == (7, 6, 80.0)


def test_unsupported_reasons_match_jax():
    for make in (make_arm, _make_ball, lambda: general_tree(model), lambda: slider_tree(model)):
        assert engine_soa_general.soa_general_unsupported_reason(make()) is None
    arm = make_arm()
    nested_free = dataclasses.replace(arm, joint_type=("ball", "free"))
    weld = dataclasses.replace(arm, joint_type=("ball", "weld"))
    for bad, jax_bad in ((nested_free, dataclasses.replace(jax_make_arm(), joint_type=("ball", "free"))),
                         (weld, dataclasses.replace(jax_make_arm(), joint_type=("ball", "weld")))):
        reason = engine_soa_general.soa_general_unsupported_reason(bad)
        assert reason is not None
        assert reason == jax_general.soa_general_unsupported_reason(jax_bad)


# -- (a) the lane functions -----------------------------------------------------


def assert_lanes_close(got, want, atol=1e-6):
    got, want = stacked([x.numpy() for x in got]), stacked(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


SUBSTEP_CASES = {
    "arm": (jax_make_arm, make_arm, arm_states, CONTACT, None),
    "ball": (lambda **kw: jax_make_ball(), lambda **kw: _make_ball(), ball_states, {}, None),
    "general": (lambda **kw: general_tree(jax_model), lambda **kw: general_tree(model),
                general_states, {}, None),
    "general_uncapped_on_waves": (
        lambda **kw: general_tree(jax_model, cap=False), lambda **kw: general_tree(model, cap=False),
        general_states, {}, ROUGH,
    ),
    "slider": (lambda **kw: slider_tree(jax_model), lambda **kw: slider_tree(model),
               slider_states, {}, None),
}


@pytest.mark.parametrize("case", list(SUBSTEP_CASES))
def test_substep_soa_g_matches_jax(case):
    """Two substeps of one tree, the second from the first's output."""
    jax_make, port_make, states, kw, rough = SUBSTEP_CASES[case]
    jm, tm = jax_make(**kw), port_make(**kw)
    jt = None if rough is None else jax_terrain.rough_terrain(**rough)
    tt = None if rough is None else terrain.rough_terrain(**rough)
    qpos, qvel, tau = states(np.random.RandomState(0))
    jq, jv = jax_lanes(qpos), jax_lanes(qvel)
    tq, tv = torch_lanes(qpos), torch_lanes(qvel)
    for _ in range(2):
        jq, jv, jn = jax_general.substep_soa_g(jm, jq, jv, jax_lanes(tau), 0.002, terrain=jt)
        tq, tv, tn = engine_soa_general.substep_soa_g(tm, tq, tv, torch_lanes(tau), 0.002, terrain=tt)
    assert_lanes_close(tq, jq)
    assert_lanes_close(tv, jv, atol=1e-5)
    assert len(tn) == len(jn) == len(tm.geom_body) + len(tm.pair_geom_a)
    assert_lanes_close(tn, jn, atol=1e-4)
    assert np.abs(stacked(jv) - qvel).max() > 1e-3  # the step did something
    if case != "arm":
        assert (stacked(jn) > 0).any() and (stacked(jn) == 0).any()


def test_crba_chol_soa_g_matches_jax():
    """The factor of M + armature + dt D on the general tree: 12 x 12,
    with the entries no joint couples left out (None) on both sides."""
    jm, tm = general_tree(jax_model), general_tree(model)
    qpos, _, _ = general_states(np.random.RandomState(1))
    want = jax_general.crba_chol_soa_g(jm, jax_general.kin_soa_g(jm, jax_lanes(qpos)), 0.002)
    got = engine_soa_general.crba_chol_soa_g(
        tm, engine_soa_general.kin_soa_g(tm, torch_lanes(qpos)), 0.002
    )
    assert len(got) == 12
    for row_got, row_want in zip(got, want):
        assert len(row_got) == len(row_want)
        assert_lanes_close(row_got, row_want)


def test_scene_substep_soa_matches_jax_through_the_cross_contact():
    jax_models = (jax_make_arm(**CONTACT), jax_make_ball())
    models = (make_arm(**CONTACT), _make_ball())
    pairs = ((0, 0, 1, 0),)
    qposs, qvels, taus = pusher_states(np.random.RandomState(2))
    jq, jv = tuple(map(jax_lanes, qposs)), tuple(map(jax_lanes, qvels))
    tq, tv = tuple(map(torch_lanes, qposs)), tuple(map(torch_lanes, qvels))
    for _ in range(2):
        jq, jv, jn, jc = jax_general.scene_substep_soa(
            jax_models, pairs, jq, jv, tuple(map(jax_lanes, taus)), DT
        )
        tq, tv, tn, tc = engine_soa_general.scene_substep_soa(
            models, pairs, tq, tv, tuple(map(torch_lanes, taus)), DT
        )
    for t in range(2):
        assert_lanes_close(tq[t], jq[t])
        assert_lanes_close(tv[t], jv[t], atol=1e-5)
        assert_lanes_close(tn[t], jn[t], atol=1e-4)
    assert_lanes_close(tc, jc, atol=1e-4)
    cross = stacked(jc)
    assert cross[0, 0] > 0 and (cross == 0).any()  # the pair fires in env 0, not everywhere
    assert (stacked(jn[1]) > 0).any()  # the ball touches the ground somewhere


# -- (b) the control step against the generic engine and the Pallas kernel --------


def test_scene_step_plain_matches_engine_step_on_one_tree():
    """The arm alone, four substeps of 5 ms (the reacher's step), against
    the generic engine: qpos 2e-5, qvel 2e-4 (tests/test_soa_general.py)."""
    jm, tm = jax_make_arm(), make_arm()
    qpos, qvel, tau = arm_states(np.random.RandomState(3))
    want = jax.jit(jax.vmap(lambda q, v, t: jax_engine_step(jm, q, v, t, 0.005, n_substeps=4)))(
        qpos, qvel, tau
    )
    got = scene_step_plain((tm,), (), *map(torch.from_numpy, (qpos, qvel, tau)), 0.005, 4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-4)
    assert got[2].shape == (B, 1)


@pytest.fixture(scope="module")
def pusher_scene():
    """The arm + ball scene, its state as concatenated numpy arrays, and
    the port's runner's output on them."""
    jax_models = (jax_make_arm(**CONTACT), jax_make_ball())
    models = (make_arm(**CONTACT), _make_ball())
    pairs = ((0, 0, 1, 0),)
    qposs, qvels, taus = pusher_states(np.random.RandomState(4))
    cat = [np.concatenate(x, axis=1) for x in (qposs, qvels, taus)]
    run = make_scene_control_step_runner(models, pairs, DT, 4)
    before = scene_step_cuda.launches
    got = run(*map(torch.from_numpy, cat))
    assert scene_step_cuda.launches == before  # CPU tensors: the plain version
    return dict(jax_models=jax_models, models=models, pairs=pairs, parts=(qposs, qvels, taus),
                cat=cat, got=got)


def test_scene_runner_matches_scene_step_of_the_generic_engine(pusher_scene):
    """Four substeps through the cross contact against scene.scene_step:
    qpos 2e-5, qvel 5e-4, cross normal 1e-4 (tests/test_soa_general.py)."""
    s = pusher_scene
    scene = JaxScene(models=s["jax_models"], pairs=s["pairs"])
    (aq, bq), (av, bv), (at, _) = s["parts"]

    def one(aq, av, bq, bv, t):
        return jax_scene_step(scene, (aq, bq), (av, bv), (t, jnp.zeros(6)), DT, n_substeps=4)

    (w_aq, w_bq), (w_av, w_bv), w_cross = jax.jit(jax.vmap(one))(aq, av, bq, bv, at)
    qpos, qvel, normals = (x.numpy() for x in s["got"])
    np.testing.assert_allclose(qpos, np.concatenate([w_aq, w_bq], 1), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(qvel, np.concatenate([w_av, w_bv], 1), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(normals[:, 2:], np.asarray(w_cross), rtol=1e-4, atol=1e-4)
    assert np.asarray(w_cross).max() > 0


def test_scene_runner_matches_the_pallas_kernel_in_interpret_mode(pusher_scene):
    """The TPU kernel itself, interpreted on the CPU with one tile of B
    lanes: the same lane functions, so the lane tolerances hold."""
    s = pusher_scene
    want = pallas_scene_step(
        s["jax_models"], s["pairs"], *map(jnp.asarray, s["cat"]), DT, 4, tile=B, interpret=True
    )
    for got, w, atol in zip(s["got"], want, (1e-6, 1e-5, 1e-4)):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=atol)


# -- (c) normals order and shape ----------------------------------------------------


def test_normals_are_per_tree_then_cross_pairs(pusher_scene):
    """Columns: arm ground geom, ball ground geom, cross pair; and the
    wrapper's output equals the last substep's lane normals."""
    s = pusher_scene
    normals = s["got"][2]
    assert normals.shape == (B, 3) and s["got"][0].shape == (B, 12) and s["got"][1].shape == (B, 10)
    tq, tv = tuple(map(torch_lanes, s["parts"][0])), tuple(map(torch_lanes, s["parts"][1]))
    for _ in range(4):
        tq, tv, tree_normals, cross = engine_soa_general.scene_substep_soa(
            s["models"], s["pairs"], tq, tv, tuple(map(torch_lanes, s["parts"][2])), DT
        )
    want = torch.stack([tree_normals[0][0], tree_normals[1][0], cross[0]], dim=1)
    torch.testing.assert_close(normals, want, rtol=0, atol=0)
    assert (normals[:, 0] == 0).all() and (normals[:, 1] > 0).any() and normals[0, 2] > 0

    # Two trees with a pair inside the first, and two cross pairs.
    models = (general_tree(model), slider_tree(model))
    plan = SceneStepPlan(models, ((0, 0, 1, 0), (1, 1, 0, 2)), 0.002, 1)
    assert plan.n_normals == (3 + 1) + 2 + 2
    p = pack_scene_params(plan)
    assert list(p.geom_slot) == [0, 1, 2, 4, 5] and list(p.pair_slot) == [3, 6, 7]
    assert list(p.pair_a) == [1, 0, 4] and list(p.pair_b) == [2, 3, 2]


def test_a_scene_without_contacts_returns_one_zero_column():
    """The JAX kernel pads its normals to one row; the port's versions
    both take that shape."""
    bare = dataclasses.replace(make_arm(), geom_body=(), geom_offset=np.zeros((0, 3)),
                               geom_radius=np.zeros(0))
    jax_bare = dataclasses.replace(jax_make_arm(), geom_body=(), geom_offset=np.zeros((0, 3)),
                                   geom_radius=np.zeros(0))
    qpos, qvel, tau = arm_states(np.random.RandomState(5))
    run = make_scene_control_step_runner((bare,), (), 0.005, 2)
    got = run(*map(torch.from_numpy, (qpos, qvel, tau)))
    assert run.n_normals == 1 and got[2].shape == (B, 1) and not got[2].any()
    want = pallas_scene_step((jax_bare,), (), *map(jnp.asarray, (qpos, qvel, tau)), 0.005, 2,
                             tile=B, interpret=True)
    assert want[2].shape == (B, 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


# -- the kernel's wrapper, as far as the CPU reaches -----------------------------------


def test_scene_struct_packing_and_build_spec():
    arm, ball = make_arm(shoulder_height=0.55, friction_vel=1.0, max_contact_force=60.0), _make_ball()
    plan = SceneStepPlan((arm, ball), ((0, 0, 1, 0),), DT, 16)
    assert plan.sizes == dict(SS_NT=2, SS_NB=3, SS_NQ=12, SS_NV=10, SS_MV=6, SS_NG=2, SS_NP=1, SS_NW=0,
                              SS_G=plan.group_size)
    assert tuple(plan.sizes) == SIZE_NAMES
    name, flags = plan.kernel_spec
    assert name == "scene_step" and "-DSS_NQ=12" in flags and "-fmad=false" in flags
    assert "--use_fast_math" not in flags
    p = pack_scene_params(plan)
    assert ctypes.sizeof(p) <= 4096 and ctypes.sizeof(p) % 4 == 0
    assert (p.n_substeps, p.terrain_mode, p.n_normals) == (16, 0, 3) and p.dt == np.float32(DT)
    assert list(p.parent) == [-1, 0, -1] and list(p.joint_type) == [1, 2, 0]
    assert list(p.q_start) == [0, 4, 5] and list(p.v_start) == [0, 3, 4] and list(p.n_dof) == [3, 1, 6]
    assert list(p.tree_body_start) == [0, 2] and list(p.tree_v_start) == [0, 4]
    assert list(p.is_leaf) == [0, 1, 1] and list(p.geom_body) == [1, 2]
    # Cross-pair parameters: means, the larger knee, the smaller cap.
    assert p.pair_stiffness[0] == 4000.0 and p.pair_damping[0] == 75.0
    assert p.pair_friction[0] == np.float32(0.7) and p.pair_friction_vel[0] == 1.0
    assert p.pair_max_force[0] == 60.0 and p.pair_radius_sum[0] == np.float32(0.03 + 0.08)
    assert list(p.max_contact_force) == [60.0, 80.0]
    assert p.lower[3] == np.float32(-2.6) and np.isinf(p.lower[0]) and np.isinf(p.upper[9])
    np.testing.assert_allclose(list(p.dt_damping)[:4], [DT * 0.8] * 4, rtol=1e-6)
    # An uncapped model packs +inf; analytic waves switch terrain_mode.
    waves = SceneStepPlan((general_tree(model, cap=False),), (), 0.002, 1,
                          terrain.rough_terrain(**ROUGH))
    pw = pack_scene_params(waves)
    assert np.isinf(pw.max_contact_force[0]) and pw.terrain_mode == 1 and waves.sizes["SS_NW"] == 6
    # Both sliders' lin-lin blocks are constants in their parents' frames
    # and fold into them on the host.
    assert list(pw.fold_c) == [0, 0, 1, 1, 0]


def test_runner_rejects_what_the_kernel_cannot_take():
    arm = make_arm()
    qpos, qvel, tau = map(torch.from_numpy, arm_states(np.random.RandomState(6)))
    run = make_scene_control_step_runner((arm,), (), 0.005, 2)
    with pytest.raises(ValueError, match="qpos_cat"):
        run(qpos[:, :4], qvel, tau)
    with pytest.raises(ValueError, match="tau_cat"):
        run(qpos, qvel, tau[:, :3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        run.cuda(qpos, qvel, tau)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scene_step_cuda((arm,), (), qpos, qvel, tau, 0.005, 2)
    with pytest.raises(ValueError, match="no implementation for device"):
        run(qpos.to("meta"), qvel.to("meta"), tau.to("meta"))


@pytest.mark.parametrize(
    "build, error, match",
    [
        (lambda: make_scene_control_step_runner(
            (dataclasses.replace(make_arm(), joint_type=("ball", "weld")),), (), DT, 2),
         ValueError, "scene kernel unsupported: unsupported joint type 'weld'"),
        (lambda: make_scene_control_step_runner(
            (dataclasses.replace(make_arm(), joint_type=("ball", "free")),), (), DT, 2),
         ValueError, "scene kernel unsupported: FREE joints are supported at tree roots only"),
        (lambda: make_scene_control_step_runner(
            (make_arm(),), (), DT, 2,
            terrain=terrain.HeightGrid.sample(terrain.rough_terrain(**ROUGH), extent=2.0, n=8)),
         ValueError, "HeightGrid"),
        (lambda: Scene(models=(make_arm(), _make_ball()), pairs=((0, 0, 0, 0),)),
         ValueError, "cross-tree pair within one tree"),
        (lambda: Scene(models=(make_arm(), _make_ball()), pairs=((0, 0, 2, 0),)),
         ValueError, "tree index 2 out of range"),
        (lambda: Scene(models=(make_arm(), _make_ball()), pairs=((0, 1, 1, 0),)),
         ValueError, "geom index 1 out of range for tree 0"),
        # scene_step / scene_forward are ported; a state tuple with no
        # entry for a tree is refused (JAX's zip would drop the tree).
        (lambda: scene_module.scene_step(Scene(models=(make_arm(),)), (), (), (), DT),
         ValueError, "one entry per tree"),
        (lambda: scene_module.scene_forward(Scene(models=(make_arm(),)), (), (), ()),
         ValueError, "one entry per tree"),
    ],
    ids=["joint_type", "nested_free", "heightgrid", "pair_in_one_tree", "tree_index", "geom_index",
         "scene_step", "scene_forward"],
)
def test_refusals(build, error, match):
    with pytest.raises(error, match=match):
        build()


def test_scene_validation_matches_jax():
    with pytest.raises(ValueError, match="cross-tree pair within one tree"):
        JaxScene(models=(jax_make_arm(), jax_make_ball()), pairs=((0, 0, 0, 0),))
    scene = Scene(models=(make_arm(), _make_ball()), pairs=((0, 0, 1, 0),))
    assert scene.pairs == ((0, 0, 1, 0),) and len(scene.models) == 2
