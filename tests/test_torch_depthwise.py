"""The depth-wise engine of nnx_ppo_tpu_torch (mirrors all 14 tests of
``tests/test_physics_depthwise.py``), and the legged env's ``depthwise``.

Every case runs the port's function on the same numpy inputs as JAX's
``*_dw`` (vmapped, eager) and as a generic engine:

* against JAX's depth-wise function: rtol 1e-4 / atol 1e-4 on qacc
  and the normals (on random trees atol 1e-6 of the largest qacc entry),
  the same equations in the same order in float32: only the einsum and
  matmul reductions may round differently, and the solve by the mass
  matrix amplifies that; 1e-5 / 1e-5 on the mass matrix;
* against a generic engine, JAX's own limit: rtol 2e-4 / atol 2e-3
  (5e-4 / 5e-3 on random trees and for the held inverse), the generic
  engine being the port's where it has the feature and JAX's for a
  per-body mass scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.envs import QuadrupedJoystick as JaxQuadrupedJoystick
from nnx_ppo_tpu.ops.linalg import cholesky_backsub as jax_cholesky_backsub
from nnx_ppo_tpu.physics import engine as jax_engine
from nnx_ppo_tpu.physics import engine_depthwise as jax_dw
from nnx_ppo_tpu.physics.model import ModelBuilder as JaxModelBuilder
from nnx_ppo_tpu.physics.models import make_humanoid as jax_make_humanoid
from nnx_ppo_tpu.physics.models import make_quadruped as jax_make_quadruped
from nnx_ppo_tpu.physics.randomize import DomainParams as JaxDomainParams
from nnx_ppo_tpu.physics.randomize import DomainRandomization as JaxDomainRandomization
from nnx_ppo_tpu.physics.terrain import rough_terrain as jax_rough_terrain
from nnx_ppo_tpu_torch.convert import legged_state_data
from nnx_ppo_tpu_torch.envs import HumanoidJoystick, LeggedJoystick, QuadrupedJoystick, State
from nnx_ppo_tpu_torch.ops.linalg import cholesky_backsub
from nnx_ppo_tpu_torch.physics import (
    DepthPlan,
    DomainParams,
    DomainRandomization,
    forward_dynamics,
    forward_dynamics_dw,
    fwd_kinematics,
    mass_matrix,
    mass_matrix_dw,
    mass_matrix_factor_dw,
    mass_matrix_inverse_dw,
)
from nnx_ppo_tpu_torch.physics.engine import mass_matrix_factor
from nnx_ppo_tpu_torch.physics.model import FREE, HINGE, ModelBuilder
from nnx_ppo_tpu_torch.physics.models import make_arm, make_humanoid, make_quadruped
from nnx_ppo_tpu_torch.physics.models import humanoid as hu
from nnx_ppo_tpu_torch.physics.models import quadruped as qd
from nnx_ppo_tpu_torch.physics.terrain import rough_terrain

torch.set_num_threads(1)

DT = 0.002
TIGHT = dict(rtol=1e-4, atol=1e-4)
JAX_LIMIT = dict(rtol=2e-4, atol=2e-3)
MODELS = {"quadruped": (make_quadruped, jax_make_quadruped, qd.default_qpos),
          "humanoid": (make_humanoid, jax_make_humanoid, hu.default_qpos)}


def t(x):
    return torch.from_numpy(np.asarray(x))


def _random_states(model, default_qpos, B, seed=0):
    """JAX's ``_random_states`` drawn by numpy: joint angles and height
    jittered around the standing pose, random velocities and torques."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(default_qpos(model), (B, 1)).astype(np.float32)
    qpos[:, 7:] += 0.2 * rng.randn(B, model.nj).astype(np.float32)
    qpos[:, 2] += 0.05 * rng.randn(B).astype(np.float32)
    qvel = (0.5 * rng.randn(B, model.nv)).astype(np.float32)
    tau = np.concatenate([np.zeros((B, 6)), 2.0 * rng.randn(B, model.nj)], -1).astype(np.float32)
    return qpos, qvel, tau


def _jax_dw(jax_model, qpos, qvel, tau, chol=None, **kw):
    """JAX's forward_dynamics_dw vmapped over the envs (and ``chol``)."""
    plan = jax_dw.DepthPlan.build(jax_model)
    args = [jnp.asarray(x) for x in (qpos, qvel, tau)]
    if chol is not None:
        args.append(jnp.asarray(chol))
    return jax.jit(jax.vmap(lambda qp, qv, tt, *L: jax_dw.forward_dynamics_dw(
        jax_model, plan, qp, qv, tt, dt=DT, chol=L[0] if L else None, **kw)))(*args)


def _assert_pair(got, want, tol, what=""):
    for g, w, name in zip(got, want, ("qacc", "normals")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=f"{what} {name}", **tol)


def _check(model, jax_model, qpos, qvel, tau, jax_kw=None, generic=True, **kw):
    """Port dw against JAX's dw (TIGHT) and the port's generic engine
    (JAX's limit); returns the port's result."""
    plan = DepthPlan.build(model)
    got = forward_dynamics_dw(model, plan, t(qpos), t(qvel), t(tau), dt=DT, **kw)
    _assert_pair(got, _jax_dw(jax_model, qpos, qvel, tau, **(jax_kw or {})), TIGHT, "jax dw")
    if generic:
        ref = forward_dynamics(model, t(qpos), t(qvel), t(tau), dt=DT, **kw)
        _assert_pair(got, ref, JAX_LIMIT, "generic")
    return got


@pytest.mark.parametrize("name", list(MODELS))
def test_matches_generic(name):
    make, jax_make, default_qpos = MODELS[name]
    model = make()
    _check(model, jax_make(), *_random_states(model, default_qpos, B=4))


def test_matches_with_held_factor():
    model, jax_model = make_quadruped(), jax_make_quadruped()
    qpos, qvel, tau = _random_states(model, qd.default_qpos, B=4)
    chol = mass_matrix_factor(model, t(qpos), dt=DT)
    _check(model, jax_model, qpos, qvel, tau, chol=chol,
           jax_kw=dict(chol=chol.numpy()))


def test_matches_with_terrain():
    model = make_quadruped()
    qpos, qvel, tau = _random_states(model, qd.default_qpos, B=4, seed=5)
    _check(model, jax_make_quadruped(), qpos, qvel, tau,
           terrain=rough_terrain(amplitude=0.06, seed=3),
           jax_kw=dict(terrain=jax_rough_terrain(amplitude=0.06, seed=3)))


def test_matches_with_joint_limits():
    model = make_quadruped(joint_limits=True)
    qpos, qvel, tau = _random_states(model, qd.default_qpos, B=4, seed=7)
    assert model.joint_lower.size and np.isfinite(model.joint_lower).any()
    _check(model, jax_make_quadruped(joint_limits=True), qpos, qvel, tau)


def test_matches_with_domain_params():
    """Per-env DR draws ([B] each), against JAX vmapped over them."""
    model = make_quadruped()
    qpos, qvel, tau = _random_states(model, qd.default_qpos, B=4, seed=9)
    draws = {k: np.asarray(v, np.float32) for k, v in
             dict(mass_scale=[1.15, 0.9, 1.0, 1.2], friction=[0.5, 0.9, 0.7, 0.3],
                  damping_scale=[0.8, 1.1, 1.0, 1.3]).items()}
    plan = DepthPlan.build(model)
    params = DomainParams(**{k: t(v) for k, v in draws.items()})
    got = forward_dynamics_dw(model, plan, t(qpos), t(qvel), t(tau), dt=DT, params=params)
    jax_model = jax_make_quadruped()
    jplan = jax_dw.DepthPlan.build(jax_model)
    want = jax.jit(jax.vmap(lambda qp, qv, tt, m, f, d: jax_dw.forward_dynamics_dw(
        jax_model, jplan, qp, qv, tt, dt=DT,
        params=JaxDomainParams(mass_scale=m, friction=f, damping_scale=d))))(
        *(jnp.asarray(x) for x in (qpos, qvel, tau, draws["mass_scale"], draws["friction"],
                                   draws["damping_scale"])))
    _assert_pair(got, want, TIGHT, "jax dw")
    _assert_pair(got, forward_dynamics(model, t(qpos), t(qvel), t(tau), dt=DT, params=params),
                 JAX_LIMIT, "generic")


def test_matches_with_per_body_mass_scale():
    """DR mass_scale per body ([NB]), gathered per level; the port's
    generic engine takes a scale per env only, so the generic reference
    here is JAX's."""
    model, jax_model = make_quadruped(), jax_make_quadruped()
    qpos, qvel, tau = _random_states(model, qd.default_qpos, B=1, seed=29)
    scale = np.clip(1.0 + 0.3 * np.random.RandomState(30).randn(model.n_bodies), 0.5,
                    1.5).astype(np.float32)
    got = forward_dynamics_dw(model, DepthPlan.build(model), t(qpos[0]), t(qvel[0]), t(tau[0]),
                              dt=DT, params=DomainParams(mass_scale=t(scale)))
    jparams = JaxDomainParams(mass_scale=jnp.asarray(scale))
    args = (jnp.asarray(qpos[0]), jnp.asarray(qvel[0]), jnp.asarray(tau[0]))
    jplan = jax_dw.DepthPlan.build(jax_model)
    want = jax.jit(lambda *a: jax_dw.forward_dynamics_dw(jax_model, jplan, *a, dt=DT,
                                                         params=jparams))(*args)
    _assert_pair(got, want, TIGHT, "jax dw")
    generic = jax.jit(lambda *a: jax_engine.forward_dynamics(jax_model, *a, dt=DT, params=jparams))
    _assert_pair(got, generic(*args), JAX_LIMIT, "jax generic")


def test_matches_with_external_force():
    model = make_quadruped()
    qpos, qvel, tau = _random_states(model, qd.default_qpos, B=4, seed=11)
    force = np.tile(np.asarray([25.0, -10.0, 0.0], np.float32), (4, 1))
    plan = DepthPlan.build(model)
    got = forward_dynamics_dw(model, plan, t(qpos), t(qvel), t(tau), dt=DT,
                              external_forces=[(0, t(qpos[:, 0:3]), t(force))])
    jax_model = jax_make_quadruped()
    jplan = jax_dw.DepthPlan.build(jax_model)
    want = jax.jit(jax.vmap(lambda qp, qv, tt, fw: jax_dw.forward_dynamics_dw(
        jax_model, jplan, qp, qv, tt, dt=DT, external_forces=[(0, qp[0:3], fw)])))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(tau), jnp.asarray(force))
    _assert_pair(got, want, TIGHT, "jax dw")
    ref = forward_dynamics(model, t(qpos), t(qvel), t(tau), dt=DT,
                           external_forces=[(0, t(qpos[:, 0:3]), t(force))])
    _assert_pair(got, ref, JAX_LIMIT, "generic")


@pytest.mark.parametrize("name", list(MODELS))
def test_mass_matrix_gram_form_matches_crba(name):
    """Gram-form M (common-frame axes + ancestor mask) == CRBA, with the
    robot 40+ m from the world origin (conditioning)."""
    make, jax_make, default_qpos = MODELS[name]
    model, jax_model = make(), jax_make()
    qpos, _, _ = _random_states(model, default_qpos, B=4, seed=13)
    qpos[:, 0:2] += 30.0
    got = mass_matrix_dw(model, DepthPlan.build(model), t(qpos))
    jplan = jax_dw.DepthPlan.build(jax_model)
    want = jax.jit(jax.vmap(lambda q: jax_dw.mass_matrix_dw(jax_model, jplan, q)))(
        jnp.asarray(qpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    ref = mass_matrix(model, fwd_kinematics(model, t(qpos)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **JAX_LIMIT)


def test_mass_matrix_factor_dw_matches():
    """The factor (implicit damping and DR per env) through a solve,
    against JAX's factor and the generic one."""
    model, jax_model = make_quadruped(), jax_make_quadruped()
    qpos, _, tau = _random_states(model, qd.default_qpos, B=2, seed=17)
    scales = dict(mass_scale=np.float32([0.9, 1.1]), damping_scale=np.float32([1.2, 0.7]))
    params = DomainParams(**{k: t(v) for k, v in scales.items()})
    L = mass_matrix_factor_dw(model, DepthPlan.build(model), t(qpos), dt=DT, params=params)
    got = cholesky_backsub(L, t(tau))
    jplan = jax_dw.DepthPlan.build(jax_model)
    want = jax.jit(jax.vmap(lambda q, r, m, d: jax_cholesky_backsub(
        jax_dw.mass_matrix_factor_dw(jax_model, jplan, q, dt=DT,
                                     params=JaxDomainParams(mass_scale=m, damping_scale=d)), r)))(
        jnp.asarray(qpos), jnp.asarray(tau), jnp.asarray(scales["mass_scale"]),
        jnp.asarray(scales["damping_scale"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    ref = cholesky_backsub(mass_matrix_factor(model, t(qpos), dt=DT, params=params), t(tau))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **JAX_LIMIT)


def test_held_inverse_matches_held_factor():
    """The explicit inverse solves the held factor's system (one matvec
    against two substitutions), rtol 5e-4 / atol 5e-3 (JAX's); and it
    equals JAX's inverse path at TIGHT."""
    model, jax_model = make_quadruped(), jax_make_quadruped()
    plan = DepthPlan.build(model)
    qpos, qvel, tau = _random_states(model, qd.default_qpos, B=4, seed=19)
    args = (t(qpos), t(qvel), t(tau))
    ref = forward_dynamics_dw(model, plan, *args, dt=DT,
                              chol=mass_matrix_factor_dw(model, plan, t(qpos), dt=DT))[0]
    minv = mass_matrix_inverse_dw(model, plan, t(qpos), dt=DT)
    got = forward_dynamics_dw(model, plan, *args, dt=DT, minv=minv)[0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=5e-4, atol=5e-3)
    jplan = jax_dw.DepthPlan.build(jax_model)
    want = jax.jit(jax.vmap(lambda qp, qv, tt: jax_dw.forward_dynamics_dw(
        jax_model, jplan, qp, qv, tt, dt=DT,
        minv=jax_dw.mass_matrix_inverse_dw(jax_model, jplan, qp, dt=DT))[0]))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(tau))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


def test_matches_with_collision_pairs_quadruped():
    model = make_quadruped(self_collision=True)
    assert model.pair_geom_a
    _check(model, jax_make_quadruped(self_collision=True),
           *_random_states(model, qd.default_qpos, B=4, seed=21))


def _two_arms(builder):
    b = builder()
    b.add_body("base", joint=FREE, mass=2.0, inertia=(0.02, 0.02, 0.02))
    for side, sign in (("L", 1.0), ("R", -1.0)):
        b.add_body(f"{side}_arm", parent="base", joint=HINGE, axis=(1.0, 0.0, 0.0),
                   pos=(0.0, sign * 0.05, 0.0), mass=0.4, com=(0.0, sign * 0.1, 0.0),
                   inertia=(0.002, 0.002, 0.002), damping=0.5)
    # Sphere centers 0.16 m apart with radius 0.1 each: 0.04 m deep at q = 0.
    ga = b.add_sphere_geom("L_arm", (0.0, 0.03, 0.0), 0.1)
    gb = b.add_sphere_geom("R_arm", (0.0, -0.03, 0.0), 0.1)
    b.add_collision_pair(ga, gb)
    return b.finalize(contact_stiffness=800.0, contact_damping=20.0)


def test_matches_with_active_collision_pair():
    model, jax_model = _two_arms(ModelBuilder), _two_arms(JaxModelBuilder)
    rng = np.random.RandomState(23)
    qpos = np.tile(np.float32([0, 0, 1, 1, 0, 0, 0, 0, 0]), (4, 1))
    qpos[:, 7:] += 0.1 * rng.randn(4, 2).astype(np.float32)
    qvel = (0.3 * rng.randn(4, model.nv)).astype(np.float32)
    _, normals = _check(model, jax_model, qpos, qvel, np.zeros((4, model.nv), np.float32))
    assert float(normals[:, -1].min()) > 0.0  # the pair is active


def _random_hinge_tree(builder, seed):
    """JAX's random free-base all-hinge tree with contact spheres and a
    collision pair, built by ``builder`` (the JAX or the port one)."""
    rng = np.random.RandomState(seed)
    n_bodies = rng.randint(4, 10)
    b = builder(gravity=-9.81)
    names, geoms, geom_body = [], [], []
    for i in range(n_bodies):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        name = f"b{i}"
        b.add_body(name, parent=None if i == 0 else names[rng.randint(0, i)],
                   joint=FREE if i == 0 else HINGE, axis=tuple(axis),
                   pos=tuple(0.4 * rng.normal(size=3)), mass=float(rng.uniform(0.2, 2.0)),
                   com=tuple(0.15 * rng.normal(size=3)),
                   inertia=tuple(rng.uniform(0.01, 0.1, size=3)),
                   damping=float(rng.uniform(0.0, 1.0)), armature=float(rng.uniform(0.0, 0.02)))
        names.append(name)
        if rng.rand() < 0.7:
            geoms.append(b.add_sphere_geom(name, tuple(0.2 * rng.normal(size=3)),
                                           float(rng.uniform(0.03, 0.12))))
            geom_body.append(i)
    pairs = [(geoms[i], geoms[j]) for i in range(len(geoms)) for j in range(i + 1, len(geoms))
             if geom_body[i] != geom_body[j]]
    if pairs:
        b.add_collision_pair(*pairs[rng.randint(len(pairs))])
    return b.finalize(contact_stiffness=2_000.0, contact_damping=50.0)


@pytest.mark.parametrize("seed", range(6))
def test_random_trees_match_generic(seed):
    model = _random_hinge_tree(ModelBuilder, seed)
    jax_model = _random_hinge_tree(JaxModelBuilder, seed)
    rng = np.random.RandomState(100 + seed)
    quat = rng.normal(size=4)
    quat /= np.linalg.norm(quat)
    qpos = np.concatenate([0.3 * rng.normal(size=2), [0.2 + 0.3 * rng.rand()], quat,
                           rng.uniform(-1.0, 1.0, size=model.nv - 6)]).astype(np.float32)
    qvel = rng.uniform(-1.0, 1.0, size=model.nv).astype(np.float32)
    tau = rng.normal(size=model.nv).astype(np.float32)
    plan = DepthPlan.build(model)
    got = forward_dynamics_dw(model, plan, t(qpos), t(qvel), t(tau), dt=DT)
    jplan = jax_dw.DepthPlan.build(jax_model)
    want = jax.jit(lambda *a: jax_dw.forward_dynamics_dw(jax_model, jplan, *a, dt=DT))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(tau))
    # The random trees' stiff contacts give qacc entries in the thousands;
    # float32 rounding of those couples into the small entries through
    # the solve (JAX's two engines differ as much), so the atol against
    # JAX's dw is 1e-6 of the largest entry (2.4e-3 at most here).
    scale = float(np.abs(np.asarray(want[0])).max())
    _assert_pair(got, want, dict(rtol=1e-4, atol=max(1e-4, 1e-6 * scale)), "jax dw")
    ref = forward_dynamics(model, t(qpos), t(qvel), t(tau), dt=DT)
    _assert_pair(got, ref, dict(rtol=5e-4, atol=5e-3), "generic")
    M = mass_matrix_dw(model, plan, t(qpos))
    np.testing.assert_allclose(M.numpy(), np.asarray(jax.jit(
        lambda q: jax_dw.mass_matrix_dw(jax_model, jplan, q))(jnp.asarray(qpos))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(M.numpy(), mass_matrix(model, fwd_kinematics(model, t(qpos))).numpy(),
                               rtol=5e-4, atol=5e-3)


def test_unsupported_models_are_rejected():
    with pytest.raises(ValueError) as want:
        jax_dw.DepthPlan.build(__import__("nnx_ppo_tpu.physics.models.arm",
                                          fromlist=["make_arm"]).make_arm())
    with pytest.raises(ValueError) as got:
        DepthPlan.build(make_arm())  # fixed base / ball joint
    assert str(got.value) == str(want.value)
    slide = dataclasses.replace(make_quadruped(), joint_type=("free",) + ("slide",) * 12)
    with pytest.raises(ValueError, match="hinge joints only"):
        DepthPlan.build(slide)


@pytest.mark.parametrize("name", list(MODELS))
def test_plan_is_jaxs(name):
    """Levels, geom groups, permutations and the ancestor mask equal
    JAX's plan."""
    make, jax_make, _ = MODELS[name]
    got, want = DepthPlan.build(make(self_collision=True) if name == "quadruped" else make()), \
        jax_dw.DepthPlan.build(jax_make(self_collision=True) if name == "quadruped" else jax_make())
    assert [len(lvl.bodies) for lvl in got.levels] == [len(lvl.bodies) for lvl in want.levels]
    for a, b in zip(got.levels + got.geom_groups, want.levels + want.geom_groups):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for field in ("dof_perm", "normal_perm", "ancestor_mask", "body_level", "body_slot",
                  "root_inertia"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.slot_map == want.slot_map


def test_plan_constants_are_built_once_per_device():
    plan = DepthPlan.build(make_quadruped())
    first = plan.constants(torch.device("cpu"))
    assert plan.constants(torch.device("cpu")) is first


# -- the legged env's depthwise values -----------------------------------------------


def test_depthwise_values_resolve_as_jaxs():
    """None takes the plan where the model allows and the generic engine
    otherwise; True raises JAX's ValueError outside the family; False
    never takes a plan (nnx_ppo_tpu/envs/legged.py:284-300)."""
    for kw in (dict(depthwise=None), dict(depthwise=True)):
        assert QuadrupedJoystick(substep_impl="xla", **kw)._plan is not None
        assert HumanoidJoystick(substep_impl="xla", **kw)._plan is not None
    assert QuadrupedJoystick(substep_impl="xla", depthwise=False)._plan is None
    slide = dataclasses.replace(make_quadruped(), joint_type=("free",) + ("slide",) * 12)
    env = LeggedJoystick(slide, np.zeros(12), 0.35, kp=40.0, action_scale=0.1)
    assert env._plan is None and env._control_runner is None
    with pytest.raises(ValueError, match="hinge joints only"):
        LeggedJoystick(slide, np.zeros(12), 0.35, kp=40.0, action_scale=0.1, depthwise=True)
    for depthwise in (None, True, False):
        want = JaxQuadrupedJoystick(substep_impl="xla", depthwise=depthwise)._plan is not None
        assert (QuadrupedJoystick(substep_impl="xla", depthwise=depthwise)._plan is not None) == want
    # "auto" on a supported model still takes the control-step runner.
    assert QuadrupedJoystick()._control_runner is not None


def test_legged_control_step_matches_jax_on_xla():
    """One control step of 4 envs with DR, pushes and rough terrain on the
    depth-wise engine with the held inverse (JAX's env on
    substep_impl="xla", depthwise=None, reuse_mass_matrix), JAX's draws
    injected: qpos atol 2e-5, qvel atol 5e-4 (the generic path's limits,
    test_torch_generic_envs.py)."""
    from test_torch_generic_envs import DR_RANGES, LEGGED_KW, ROUGH, jax_legged_draws, stack_np

    kw = dict(reuse_mass_matrix=True, substep_impl="xla", **LEGGED_KW)
    env = JaxQuadrupedJoystick(randomize=JaxDomainRandomization(**DR_RANGES),
                               terrain=jax_rough_terrain(**ROUGH), **kw)
    assert env._plan is not None
    keys = jax.random.split(jax.random.key(0), 4)
    actions = np.random.RandomState(5).uniform(-1.2, 1.2, (4, 12)).astype(np.float32)
    reset = jax.vmap(env.reset)(keys)
    want = jax.jit(jax.vmap(env.step))(reset, jnp.asarray(actions))
    draws = stack_np([jax_legged_draws(env, k) for k in keys])
    port = QuadrupedJoystick(randomize=DomainRandomization(**DR_RANGES),
                             terrain=rough_terrain(**ROUGH), **kw)
    assert port._plan is not None and port._control_runner is None
    data = jax.tree.map(np.asarray, {k: v for k, v in reset.data.items() if k != "key"})
    state0 = State(data=legged_state_data(data), obs=None, reward=None, done=torch.zeros(4),
                   info={}, metrics={})
    got = port._step_from(state0, t(actions), (t(draws["pushing"]), t(draws["theta"])),
                          (t(draws["resample"]), t(draws["command"])), None)
    np.testing.assert_allclose(got.data["qpos"].numpy(), np.asarray(want.data["qpos"]), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got.data["qvel"].numpy(), np.asarray(want.data["qvel"]), rtol=0,
                               atol=5e-4)
