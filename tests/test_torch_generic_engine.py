"""The generic rigid-body engine and multi-tree scenes on it against the
JAX package.

``nnx_ppo_tpu_torch/physics/engine.py`` and ``scene.py`` port JAX's
``physics/engine.py`` and ``scene.py`` function for function, batched
over leading dims. Each model's states (numpy from a seed) go through
JAX's functions, vmapped and jitted once per module-scoped fixture (the
unrolled engine is slow eagerly), and through the port's on CPU tensors.
Models: the humanoid (self-collision pairs and joint limits), the arm
(ball shoulder, fixed base), a tree with every joint type (free root,
hinge with a stop and a spring, two slides, a ball, a pair) and a
fixed-base tree rooted by a slide; the quadruped (joint limits) through ``forward_dynamics`` with an analytic terrain,
domain-randomization params, a push and a held factor, and on a
HeightGrid; the pusher's two-tree scene. ``step`` runs on the three small
models (JAX's scan of the unrolled engine doubles a model's compile).
The env steps are in test_torch_generic_envs.py.

Tolerances, float32 on both sides with the same order of operations but
another summation order inside the small matrix products: every engine
quantity ``rtol 1e-5`` and ``atol 1e-5`` times its largest entry (at least
1), 13 times the largest gap measured (7.8e-7 of the humanoid's largest
contact normal force, 1.0e3 N; qacc 4.3e-7 of 4.9e3); the qpos part of
``integrate`` and ``step`` absolute 1e-5 (gap 1.2e-7), their qvel part by
the engine rule (gap 6.1e-5 on qvel of 208 after one step of
qacc 1.0e5: four float32 ulps). The port's scene step against its own
plain scene control step (another algorithm: 6x6 spatial algebra against
the scalar lane forms): qpos 2e-6, qvel 1e-4 over three substeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.physics import engine as jax_engine
from nnx_ppo_tpu.physics import model as jax_model
from nnx_ppo_tpu.physics import scene as jax_scene
from nnx_ppo_tpu.physics.models.arm import make_arm as jax_make_arm
from nnx_ppo_tpu.physics.models import make_humanoid as jax_make_humanoid
from nnx_ppo_tpu.physics.models import make_quadruped as jax_make_quadruped
from nnx_ppo_tpu.physics.randomize import DomainParams as JaxDomainParams
from nnx_ppo_tpu.physics.terrain import HeightGrid as JaxHeightGrid
from nnx_ppo_tpu.physics.terrain import rough_terrain as jax_rough_terrain
from nnx_ppo_tpu_torch.convert import heightgrid_from_fields
from nnx_ppo_tpu_torch.physics import (
    DomainParams,
    Scene,
    bias_forces,
    engine,
    forward_dynamics,
    integrate,
    limit_torques,
    scene_forward,
    scene_step,
    step,
)
from nnx_ppo_tpu_torch.physics.cuda_scene_step import make_scene_control_step_runner, scene_step_cuda
from nnx_ppo_tpu_torch.physics.models import make_arm, make_humanoid, make_quadruped
from nnx_ppo_tpu_torch.physics.models.humanoid import default_qpos as humanoid_default_qpos
from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos as quadruped_default_qpos
from nnx_ppo_tpu_torch.physics.terrain import rough_terrain
from nnx_ppo_tpu_torch.physics.testing import (
    general_tree,
    general_tree_states,
    humanoid_states,
    manipulation_states,
    slider_tree,
    slider_tree_states,
    standing_states,
)

torch.set_num_threads(1)

B = 4
DT = 0.002
N_SUBSTEPS = 2
ROUGH = dict(seed=2, amplitude=0.03, wavelength=1.5)
DR_RANGES = dict(
    mass_scale=(0.8, 1.2), friction=(0.4, 1.0), damping_scale=(0.9, 1.1), gain_scale=(0.9, 1.1)
)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_engine_close(got, want, err_msg=""):
    """rtol 1e-5, atol 1e-5 x the largest entry (at least 1): see above."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=err_msg)


# -- the models and their states ------------------------------------------------


def _states(name):
    if name == "humanoid":
        tm = make_humanoid(self_collision=True, joint_limits=True)
        s = humanoid_states(tm, B, seed=2)
        s["tau"] = (30.0 * np.random.RandomState(2).uniform(-1, 1, (B, tm.nv))).astype(np.float32)
        return jax_make_humanoid(self_collision=True, joint_limits=True), tm, s
    if name == "arm":
        s = manipulation_states(B, seed=3, with_ball=False)
        s["qpos"][0, 4] = 2.8  # the elbow 0.2 rad past its stop
        return jax_make_arm(), make_arm(), s
    if name == "general_tree":
        return general_tree(jax_model), general_tree(), general_tree_states(B, seed=4)
    return slider_tree(jax_model), slider_tree(), slider_tree_states(B, seed=5)


MODELS = ("humanoid", "arm", "general_tree", "slider_tree")
STEP_MODELS = ("arm", "general_tree", "slider_tree")
QUANTITIES = (
    "body_velocities", "bias_forces", "geom_world_centers", "contact_tau", "contact_normals",
    "project_world_point_forces", "limit_torques", "spring_torques", "qacc", "normals",
    "integrate", "step",
)


def _point_forces(model, seed):
    """Two world-frame point forces per env: on the last body and on the
    root, at points near their origins."""
    rng = np.random.RandomState(seed)
    bodies = (model.n_bodies - 1, 0)
    points = (0.1 * rng.randn(B, 2, 3)).astype(np.float32)
    forces = (5.0 * rng.randn(B, 2, 3)).astype(np.float32)
    return bodies, points, forces


def _jax_engine(jm, bodies, n_substeps):
    """JAX's engine functions of one env, vmapped and jitted; ``step`` when
    ``n_substeps`` is not 0."""
    def one(q, v, tau, pts, fs):
        kin = jax_engine.fwd_kinematics(jm, q)
        vel = jax_engine.body_velocities(jm, kin, v)
        tau_c, normals = jax_engine.contact_generalized_forces(jm, kin, vel)
        centers = jax_engine.geom_world_centers(jm, kin)
        forces = [(b, kin.p[b] + pts[k], fs[k]) for k, b in enumerate(bodies)]
        qacc, fd_normals = jax_engine.forward_dynamics(jm, q, v, tau, dt=DT)
        out = {
            "body_velocities": jnp.concatenate(vel),
            "bias_forces": jax_engine.bias_forces(jm, kin, v, vel),
            "geom_world_centers": jnp.stack(centers) if centers else jnp.zeros((0, 3)),
            "contact_tau": tau_c,
            "contact_normals": normals,
            "project_world_point_forces": jax_engine.project_world_point_forces(jm, kin, forces),
            "qacc": qacc,
            "normals": fd_normals,
            "integrate": jnp.concatenate(jax_engine.integrate(jm, q, v, qacc, DT)),
        }
        if n_substeps:
            out["step"] = jnp.concatenate(jax_engine.step(jm, q, v, tau, DT, n_substeps)[:2])
        lim = jax_engine.limit_torques(jm, q, v)
        spring = jax_engine.spring_torques(jm, q)
        out["limit_torques"] = jnp.zeros(0) if lim is None else lim
        out["spring_torques"] = jnp.zeros(0) if spring is None else spring
        return out

    return jax.jit(jax.vmap(one))


def _port_engine(tm, s, bodies, points, forces, n_substeps):
    qpos, qvel, tau = t(s["qpos"]), t(s["qvel"]), t(s["tau"])
    kin = engine.fwd_kinematics(tm, qpos)
    vel = engine.body_velocities(tm, kin, qvel)
    tau_c, normals = engine.contact_generalized_forces(tm, kin, vel)
    centers = engine.geom_world_centers(tm, kin)
    pf = [(b, kin.p[b] + t(points[:, k]), t(forces[:, k])) for k, b in enumerate(bodies)]
    qacc, fd_normals = forward_dynamics(tm, qpos, qvel, tau, dt=DT)
    lim, spring = limit_torques(tm, qpos, qvel), engine.spring_torques(tm, qpos)
    return {
        "body_velocities": torch.cat(vel, dim=-1),
        "bias_forces": bias_forces(tm, kin, qvel, vel),
        "geom_world_centers": torch.stack(centers, dim=1) if centers else torch.zeros(B, 0, 3),
        "contact_tau": tau_c,
        "contact_normals": normals,
        "project_world_point_forces": engine.project_world_point_forces(tm, kin, pf),
        "qacc": qacc,
        "normals": fd_normals,
        "integrate": torch.cat(integrate(tm, qpos, qvel, qacc, DT), dim=-1),
        **({"step": torch.cat(step(tm, qpos, qvel, tau, DT, n_substeps)[:2], dim=-1)}
           if n_substeps else {}),
        "limit_torques": torch.zeros(B, 0) if lim is None else lim,
        "spring_torques": torch.zeros(B, 0) if spring is None else spring,
    }


@pytest.fixture(scope="module", params=MODELS)
def engine_outputs(request):
    jm, tm, s = _states(request.param)
    bodies, points, forces = _point_forces(tm, seed=len(request.param))
    n_substeps = N_SUBSTEPS if request.param in STEP_MODELS else 0
    want = _jax_engine(jm, bodies, n_substeps)(s["qpos"], s["qvel"], s["tau"], points, forces)
    got = _port_engine(tm, s, bodies, points, forces, n_substeps)
    return request.param, tm, got, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_engine_function_matches_jax(engine_outputs, quantity):
    name, tm, got, want = engine_outputs
    if quantity == "step" and name not in STEP_MODELS:
        # The humanoid's step is its forward_dynamics and integrate, both
        # checked here; JAX's scan of it would double the compile.
        assert "step" not in want
        return
    if quantity in ("integrate", "step"):
        # qpos absolute 1e-5, then qvel by the engine rule.
        g, w = got[quantity].numpy(), want[quantity]
        np.testing.assert_allclose(g[:, : tm.nq], w[:, : tm.nq], rtol=0, atol=1e-5)
        assert_engine_close(g[:, tm.nq :], w[:, tm.nq :], f"{name}: {quantity} qvel")
        return
    assert_engine_close(got[quantity], want[quantity], f"{name}: {quantity}")


def test_the_states_exercise_contacts_limits_and_springs(engine_outputs):
    """The states reach what each function computes: some ground or pair
    contact is active and some not, a stop is violated where the model has
    stops, a spring is stretched where it has springs."""
    name, tm, got, want = engine_outputs
    normals = want["contact_normals"]
    assert normals.shape == (B, len(tm.geom_body) + len(tm.pair_geom_a))
    if name == "arm":
        # The arm's shoulder sits 1 m up, out of the ground's reach; its
        # contacts are checked in the pusher's scene below.
        assert not (normals > 0).any()
    else:
        assert (normals > 0).any() and (normals == 0).any(), name
    if np.isfinite(tm.joint_lower).any():
        assert (np.abs(want["limit_torques"]) > 0).any(), name
    if (tm.spring_stiffness > 0).any():
        assert (np.abs(want["spring_torques"]) > 0).any(), name


# -- forward dynamics with terrain, params, external forces and a held factor ------


@pytest.fixture(scope="module")
def feature_outputs():
    """The quadruped's forward_dynamics (with joint limits) on an analytic
    terrain with DR params, a push at the trunk origin and a held factor;
    and on a HeightGrid with params and no factor."""
    # No self-collision pairs: JAX's sphere_pair_force annotates friction
    # as a float, and the test suite's typeguard hook refuses the traced
    # per-env friction there (the pairs are checked on the humanoid).
    jm = jax_make_quadruped(joint_limits=True)
    tm = make_quadruped(joint_limits=True)
    jt, tt = jax_rough_terrain(**ROUGH), rough_terrain(**ROUGH)
    jg = JaxHeightGrid.sample(jt, extent=8.0, n=48)
    tg = heightgrid_from_fields(np.asarray(jg.data), jg.x0, jg.y0, jg.dx, jg.dy)
    s = standing_states(tm, quadruped_default_qpos(tm), B, seed=6, terrain=tt)
    rng = np.random.RandomState(6)
    s["tau"] = (20.0 * rng.uniform(-1, 1, (B, tm.nv))).astype(np.float32)
    dr = {k: rng.uniform(lo, hi, B).astype(np.float32) for k, (lo, hi) in DR_RANGES.items()}
    push = (50.0 * rng.randn(B, 3)).astype(np.float32)

    def one(q, v, tau, dr, f):
        params = JaxDomainParams(**dr)
        chol = jax_engine.mass_matrix_factor(jm, q, dt=DT, params=params)
        held = jax_engine.forward_dynamics(
            jm, q, v, tau, dt=DT, chol=chol, terrain=jt, params=params,
            external_forces=[(0, q[0:3], f)],
        )
        grid = jax_engine.forward_dynamics(jm, q, v, tau, dt=DT, terrain=jg, params=params)
        return held, grid

    want = jax.jit(jax.vmap(one))(s["qpos"], s["qvel"], s["tau"], dr, push)
    qpos, qvel, tau = t(s["qpos"]), t(s["qvel"]), t(s["tau"])
    params = DomainParams(**{k: t(v) for k, v in dr.items()})
    chol = engine.mass_matrix_factor(tm, qpos, dt=DT, params=params)
    held = forward_dynamics(tm, qpos, qvel, tau, dt=DT, chol=chol, terrain=tt, params=params,
                            external_forces=[(0, qpos[:, 0:3], t(push))])
    grid = forward_dynamics(tm, qpos, qvel, tau, dt=DT, terrain=tg, params=params)
    return {"held": (held, want[0]), "grid": (grid, want[1])}


@pytest.mark.parametrize("case", ["held", "grid"])
def test_forward_dynamics_with_terrain_params_push_and_factor(feature_outputs, case):
    (qacc, normals), (want_qacc, want_normals) = feature_outputs[case]
    assert_engine_close(qacc, want_qacc, f"{case}: qacc")
    assert_engine_close(normals, want_normals, f"{case}: normals")
    want_normals = np.asarray(want_normals)
    assert (want_normals > 0).any() and (want_normals == 0).any()


# -- scenes -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene_outputs():
    """The pusher's scene (arm, free ball, their cross pair) with one ball
    in four at the end effector, through scene_forward and scene_step."""
    from nnx_ppo_tpu.envs.pusher import _make_ball as jax_make_ball
    from nnx_ppo_tpu_torch.envs.pusher import _make_ball

    arm_kw = dict(shoulder_height=0.55, friction_vel=1.0, max_contact_force=60.0)
    js = jax_scene.Scene(models=(jax_make_arm(**arm_kw), jax_make_ball()), pairs=((0, 0, 1, 0),))
    ts = Scene(models=(make_arm(**arm_kw), _make_ball()), pairs=((0, 0, 1, 0),))
    s = manipulation_states(B, seed=7, with_ball=True, shoulder_height=0.55)
    split = lambda x, n: (x[..., :n], x[..., n:])
    qp, qv, tau = (split(s[k], n) for k, n in (("qpos", 5), ("qvel", 4), ("tau", 4)))

    def one(qp, qv, tau):
        qaccs, cross = jax_scene.scene_forward(js, qp, qv, tau, dt=0.00125)
        qps, qvs, last = jax_scene.scene_step(js, qp, qv, tau, 0.00125, n_substeps=3)
        return qaccs, cross, qps, qvs, last

    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(qp, qv, tau))
    tq = [tuple(t(x) for x in parts) for parts in (qp, qv, tau)]
    got = (*scene_forward(ts, *tq, dt=0.00125), *scene_step(ts, *tq, 0.00125, n_substeps=3))
    return ts, s, got, want


def test_scene_forward_and_step_match_jax(scene_outputs):
    _, _, (qaccs, cross, qps, qvs, last), want = scene_outputs
    for got_qacc, want_qacc in zip(qaccs, want[0]):
        assert_engine_close(got_qacc, want_qacc, "qacc")
    assert_engine_close(cross, want[1], "cross normals")
    assert (want[1] > 0).any() and (want[1] == 0).any()  # the ball touches in some envs
    for g, w in zip(qps, want[2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    for g, w in zip(qvs, want[3]):
        assert_engine_close(g, w, "qvel")
    assert_engine_close(last, want[4], "last cross normals")


def test_scene_step_matches_the_plain_scene_runner(scene_outputs):
    """The port's generic scene step against its own plain scene control
    step (the scene kernel's plain version), from the same state."""
    ts, s, (_, _, qps, qvs, _), _ = scene_outputs
    run = make_scene_control_step_runner(ts.models, ts.pairs, 0.00125, 3)
    before = scene_step_cuda.launches
    qpos, qvel, _ = run(t(s["qpos"]), t(s["qvel"]), t(s["tau"]))
    assert scene_step_cuda.launches == before
    torch.testing.assert_close(qpos, torch.cat(qps, dim=-1), rtol=0, atol=2e-6)
    torch.testing.assert_close(qvel, torch.cat(qvs, dim=-1), rtol=0, atol=1e-4)
