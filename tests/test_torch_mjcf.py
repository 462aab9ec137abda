"""MJCF import of the port against the JAX package's and against MuJoCo.

``nnx_ppo_tpu_torch/physics/mjcf.py`` is the port's own numpy copy of
``nnx_ppo_tpu/physics/mjcf.py``. Every ``Model`` field, ``qpos0``, the
names, the actuator specs, the ball-dof rotations and a hfield's
``HeightGrid`` are compared with JAX's import of the same XML, exactly
(both are the same float64 numpy arithmetic). The XMLs are those of
``tests/test_mjcf.py`` and ``tests/test_heightgrid.py`` (fixed-base arm,
free tree, ball frames, stacked joints, joint refs, welds, capsules,
pairs, springs, hfield, the error cases).

The smooth dynamics of imported models are held to MuJoCo's own
``mj_forward`` / ``mj_fullM`` through the port's generic engine with the
tolerances of ``tests/test_mjcf.py`` (float32 engine against float64
MuJoCo): mass matrix rtol 1e-4 / atol 1e-6, qacc rtol 2e-4 / atol 2e-3
(5e-4 / 5e-3 where the free base's or a ball's velocity convention is
converted), a 150-step trajectory 5e-5, the published gymnasium and
dm_control robots by their relative error per model. ``legged_from_mjcf``
is held to JAX's wiring, and the saved MJCF quadruped import
(``physics/models/mjcf_quadruped.npz``) to a fresh import, field by field.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from nnx_ppo_tpu.envs import legged_from_mjcf as jax_legged_from_mjcf
from nnx_ppo_tpu.physics import mjcf as jax_mjcf
from nnx_ppo_tpu_torch.envs import legged_from_mjcf
from nnx_ppo_tpu_torch.physics import engine, mjcf
from nnx_ppo_tpu_torch.physics.engine import forward_dynamics, fwd_kinematics, mass_matrix, step
from nnx_ppo_tpu_torch.physics.mjcf import MjcfImport, from_mjcf, from_mjcf_scene
from nnx_ppo_tpu_torch.physics.models import mjcf_quadruped
from nnx_ppo_tpu_torch.physics.scene import scene_step
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid

torch.set_num_threads(1)

ARM_XML = """
<mujoco>
  <option gravity="0 0 -9.81"/>
  <compiler angle="radian"/>
  <worldbody>
    <body name="upper" pos="0.1 0.2 1.0" quat="0.9238795 0 0.3826834 0">
      <joint name="shoulder" type="hinge" axis="0 1 0" pos="0.02 0 0.03"
             damping="0.7" armature="0.015"/>
      <inertial pos="0.05 0.01 -0.15" mass="1.4"
                fullinertia="0.011 0.013 0.007 0.0005 0.0002 0.0008"/>
      <body name="fore" pos="0 0 -0.3" quat="0.9659258 0.2588190 0 0">
        <joint name="elbow" type="hinge" axis="1 0 0" pos="0 0.01 0"
               damping="0.4" armature="0.008"/>
        <inertial pos="0 -0.02 -0.12" mass="0.8"
                  diaginertia="0.006 0.006 0.001"/>
        <body name="wrist_weld" pos="0 0 -0.25" quat="0.7071068 0 0 0.7071068">
          <inertial pos="0.01 0 -0.02" mass="0.3"
                    diaginertia="0.0012 0.0011 0.0007"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

FREE_TREE_XML = """
<mujoco>
  <option gravity="0 0 -9.81"/>
  <compiler angle="radian"/>
  <worldbody>
    <body name="trunk" pos="0.3 -0.2 0.9" quat="0.9914449 0 0.1305262 0">
      <freejoint/>
      <inertial pos="0.02 0 0.05" mass="3.1" diaginertia="0.04 0.05 0.03"/>
      <body name="leg" pos="0.1 0.05 -0.1" quat="0.9961947 0.0871557 0 0">
        <joint type="hinge" axis="0 1 0" pos="0 0 0.02" damping="0.9"
               armature="0.01"/>
        <inertial pos="0 0 -0.2" mass="0.6" diaginertia="0.004 0.004 0.0008"/>
        <body name="foot" pos="0 0 -0.35">
          <joint type="hinge" axis="1 0 0" damping="0.3" armature="0.005"/>
          <inertial pos="0.02 0 -0.05" mass="0.2"
                    diaginertia="0.0008 0.0009 0.0004"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

TOE_XML = FREE_TREE_XML.replace(
    '<body name="foot" pos="0 0 -0.35">',
    '<body name="foot" pos="0 0 -0.35">'
    '<geom name="toe" type="sphere" size="0.04" pos="0.03 0 -0.06"/>',
).replace("<worldbody>", '<worldbody><geom name="floor" type="plane" size="5 5 0.1"/>')

FLOORLESS_TOE_XML = FREE_TREE_XML.replace(
    '<body name="foot" pos="0 0 -0.35">',
    '<body name="foot" pos="0 0 -0.35"><geom name="toe" type="sphere" size="0.04"/>',
)

ACTUATOR_XML = """
<mujoco><compiler angle="radian"/><worldbody>
<body pos="0 0 1"><joint name="j1" type="hinge" axis="0 1 0"/>
 <inertial pos="0 0 -0.2" mass="1" diaginertia="0.01 0.01 0.002"/>
 <body pos="0 0 -0.4"><joint name="j2" type="hinge" axis="0 1 0"/>
  <inertial pos="0 0 -0.2" mass="0.5" diaginertia="0.005 0.005 0.001"/>
 </body></body></worldbody>
<actuator>
  <motor name="m1" joint="j1" gear="20" ctrlrange="-1 1"/>
  <position name="p2" joint="j2" kp="45" kv="2.5" ctrlrange="-0.8 0.8"/>
</actuator></mujoco>"""

FLOORLESS_PAIR_XML = """
<mujoco><worldbody>
  <body pos="0 0 1"><freejoint/>
    <inertial pos="0 0 0" mass="1" diaginertia="0.01 0.01 0.01"/>
    <geom name="ga" type="sphere" size="0.1"/>
    <body pos="0.15 0 0"><joint type="hinge" axis="0 0 1"/>
      <inertial pos="0 0 0" mass="0.5" diaginertia="0.004 0.004 0.004"/>
      <geom name="gb" type="sphere" size="0.1"/>
    </body>
  </body>
</worldbody>
<contact><pair geom1="ga" geom2="gb"/></contact></mujoco>"""

BALL_ON_FLOOR_XML = """
<mujoco>
  <option gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <body name="ball" pos="0 0 0.5">
      <freejoint/>
      <inertial pos="0 0 0" mass="1.0" diaginertia="0.004 0.004 0.004"/>
      <geom name="sphere" type="sphere" size="0.1" friction="0.6 0.005 0.0001"/>
    </body>
  </worldbody>
</mujoco>"""

PAIR_XML = """
<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <body name="a" pos="0 0 0.5"><freejoint/>
      <inertial pos="0 0 0" mass="1" diaginertia="0.01 0.01 0.01"/>
      <geom name="ga" type="sphere" size="0.1"/>
      <body name="b" pos="0.15 0 0">
        <joint type="hinge" axis="0 0 1"/>
        <inertial pos="0 0 0" mass="0.5" diaginertia="0.004 0.004 0.004"/>
        <geom name="gb" type="sphere" size="0.1"/>
      </body>
    </body>
  </worldbody>
  <contact><pair geom1="ga" geom2="gb"/></contact>
</mujoco>"""

JOINT_REF_XML = """
<mujoco><option gravity="0 0 -9.81"/><compiler angle="radian"/>
<worldbody>
  <body pos="0 0 1">
    <joint name="h" type="hinge" axis="0 1 0" ref="1.0" damping="0.2"/>
    <inertial pos="0 0 -0.25" mass="1.0" diaginertia="0.01 0.01 0.002"/>
    <body pos="0 0 -0.5">
      <joint name="s" type="slide" axis="0 0 1" ref="0.3"/>
      <inertial pos="0 0 -0.1" mass="0.4" diaginertia="0.003 0.003 0.001"/>
    </body>
  </body>
</worldbody></mujoco>"""

BALL_FRAME_XML = """
<mujoco><option gravity="0 0 -9.81"/><compiler angle="radian"/>
<worldbody>
  <body pos="0 0 1" quat="0.9238795 0 0.3826834 0">
    <joint name="b" type="ball" damping="0.1"/>
    <inertial pos="0.02 0 -0.2" mass="1.1" diaginertia="0.01 0.009 0.003"/>
  </body>
</worldbody></mujoco>"""

LEGGED_XML = """
<mujoco><option gravity="0 0 -9.81"/><compiler angle="radian"/>
<worldbody>
  <geom name="floor" type="plane" size="5 5 0.1"/>
  <body name="trunk" pos="0 0 0.4">
    <freejoint/>
    <inertial pos="0 0 0" mass="4.0" diaginertia="0.05 0.05 0.04"/>
    <body name="L" pos="0 0.1 0">
      <joint name="Lh" type="hinge" axis="0 1 0" damping="1.0"/>
      <inertial pos="0 0 -0.18" mass="0.8" diaginertia="0.006 0.006 0.001"/>
      <geom name="Lf" type="sphere" size="0.03" pos="0 0 -0.36"/>
    </body>
    <body name="R" pos="0 -0.1 0">
      <joint name="Rh" type="hinge" axis="0 1 0" damping="1.0"/>
      <inertial pos="0 0 -0.18" mass="0.8" diaginertia="0.006 0.006 0.001"/>
      <geom name="Rf" type="sphere" size="0.03" pos="0 0 -0.36"/>
    </body>
  </body>
</worldbody>
<actuator>
  <position joint="Lh" kp="50" kv="2" ctrlrange="-0.6 0.6"/>
  <position joint="Rh" kp="50" kv="2" ctrlrange="-0.6 0.6"/>
</actuator></mujoco>"""

SPRING_XML = """
<mujoco><option gravity="0 0 -9.81"/><compiler angle="radian"/>
<worldbody><body pos="0 0 1">
  <joint name="h" type="hinge" axis="0 1 0" stiffness="30"
         springref="0.5" damping="2.0"/>
  <inertial pos="0 0 -0.3" mass="1.0" diaginertia="0.01 0.01 0.002"/>
</body></worldbody></mujoco>"""

STACKED_XML = """
<mujoco><compiler angle="radian"/><worldbody><body pos="0 0 1">
  <joint name="sx" type="slide" axis="1 0 0" damping="0.3"/>
  <joint name="hy" type="hinge" axis="0 1 0" pos="0.1 0 0.2"
         damping="0.2"/>
  <inertial pos="0.3 0 0" mass="1" diaginertia="0.01 0.01 0.01"/>
</body></worldbody></mujoco>"""

TWO_TREES_XML = """
<mujoco><worldbody>
  <body pos="0 0 1"><joint type="hinge" axis="1 0 0"/>
    <inertial pos="0 0 0" mass="1" diaginertia="0.01 0.01 0.01"/></body>
  <body pos="1 0 1"><joint type="hinge" axis="1 0 0"/>
    <inertial pos="0 0 0" mass="1" diaginertia="0.01 0.01 0.01"/></body>
</worldbody></mujoco>"""

FLUID_XML = """
<mujoco><option density="1.2" viscosity="0.1"/><worldbody>
  <body pos="0 0 1"><joint type="hinge" axis="1 0 0"/>
    <inertial pos="0 0 0" mass="1" diaginertia="0.01 0.01 0.01"/></body>
</worldbody></mujoco>"""

SCENE_XML = """
<mujoco>
  <option gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="arm_base" pos="0 0 0.12">
      <joint name="swing" type="hinge" axis="0 0 1" damping="0.5"/>
      <inertial pos="0.15 0 0" mass="1.2" diaginertia="0.01 0.01 0.004"/>
      <geom name="tip" type="capsule" size="0.05 0.1" pos="0.3 0 0"
            quat="0.7071068 0 0.7071068 0"/>
    </body>
    <body name="ball" pos="0.42 -0.2 0.1">
      <freejoint/>
      <inertial pos="0 0 0" mass="0.4" diaginertia="0.002 0.002 0.002"/>
      <geom name="ball_g" type="sphere" size="0.08" friction="0.5 0.005 0.0001"/>
    </body>
  </worldbody>
  <contact><pair geom1="tip" geom2="ball_g"/></contact>
</mujoco>
"""

HFIELD_XML = """
<mujoco>
  <asset><hfield name="hf" nrow="5" ncol="9" size="2 1 0.4 0.1"/></asset>
  <worldbody>
    <geom type="hfield" hfield="hf" pos="0.5 -0.25 0"/>
    <body pos="0 0 1"><freejoint/>
      <inertial pos="0 0 0" mass="1" diaginertia="0.01 0.01 0.01"/>
      <geom name="foot" type="sphere" size="0.05"/>
    </body>
  </worldbody>
</mujoco>"""

LEGGED_HFIELD_XML = (
    LEGGED_XML.replace('<geom name="floor" type="plane" size="5 5 0.1"/>',
                       '<geom type="hfield" hfield="hf"/>')
    .replace("<mujoco>", '<mujoco><asset><hfield name="hf" nrow="17" ncol="17" '
             'size="4 4 0.05 0.1"/></asset>', 1)
    .split("<actuator>")[0] + "</mujoco>"
)


def hfield_model(xml, seed):
    """A compiled MjModel with its hfield filled from a seed (MuJoCo
    leaves a file-less hfield at zero)."""
    m = mujoco.MjModel.from_xml_string(xml)
    m.hfield_data[:] = np.random.RandomState(seed).uniform(0.0, 1.0, m.hfield_data.shape)
    return m


# (source, from_mjcf keyword arguments)
IMPORTS = {
    "fixed_base_arm": (ARM_XML, {}),
    "free_tree": (FREE_TREE_XML, {}),
    "toe_on_floor": (TOE_XML, {}),
    "floorless_toe": (FLOORLESS_TOE_XML, {}),
    "actuators": (ACTUATOR_XML, {}),
    "forced_pair": (FLOORLESS_PAIR_XML, dict(force_contacts=True)),
    "ball_on_floor": (BALL_ON_FLOOR_XML, dict(contact_stiffness=4_000.0, contact_damping=80.0)),
    "pair": (PAIR_XML, {}),
    "joint_ref": (JOINT_REF_XML, {}),
    "ball_frame": (BALL_FRAME_XML, {}),
    "legged": (LEGGED_XML, dict(friction=0.7, max_contact_force=90.0)),
    "spring": (SPRING_XML, {}),
    "stacked_joints": (STACKED_XML, {}),
    "hfield": (lambda: hfield_model(HFIELD_XML, 3), {}),
    "mjcf_quadruped": (mjcf_quadruped.QUADRUPED_MJCF, mjcf_quadruped.IMPORT_KWARGS),
}


def source(name):
    xml, kwargs = IMPORTS[name]
    return (xml() if callable(xml) else xml), kwargs


def assert_models_equal(got, want):
    """Every Model field equal: arrays in value, dtype and shape, the rest
    in value and type."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, (f.name, a, b)


def assert_imports_equal(got, want):
    assert_models_equal(got.model, want.model)
    assert got.qpos0.dtype == want.qpos0.dtype
    np.testing.assert_array_equal(got.qpos0, want.qpos0)
    for name in ("body_names", "geom_names", "skipped_geoms", "has_ground"):
        assert getattr(got, name) == getattr(want, name), name
    assert len(got.actuators) == len(want.actuators)
    for a, b in zip(got.actuators, want.actuators):
        for slot in b.__slots__:
            assert getattr(a, slot) == getattr(b, slot), slot
    assert len(got.ball_dof_rotations) == len(want.ball_dof_rotations)
    for (da, Ra), (db, Rb) in zip(got.ball_dof_rotations, want.ball_dof_rotations):
        assert da == db
        np.testing.assert_array_equal(Ra, Rb)
    assert (got.terrain is None) == (want.terrain is None)
    if want.terrain is not None:
        np.testing.assert_array_equal(np.asarray(got.terrain.data), np.asarray(want.terrain.data))
        for name in ("x0", "y0", "dx", "dy"):
            assert getattr(got.terrain, name) == getattr(want.terrain, name), name


@pytest.mark.parametrize("name", list(IMPORTS))
def test_from_mjcf_matches_jax_field_by_field(name):
    xml, kwargs = source(name)
    got = from_mjcf(xml, **kwargs)
    assert isinstance(got, MjcfImport)
    assert_imports_equal(got, jax_mjcf.from_mjcf(xml, **kwargs))


def test_from_mjcf_scene_matches_jax_field_by_field():
    got, want = from_mjcf_scene(SCENE_XML), jax_mjcf.from_mjcf_scene(SCENE_XML)
    assert got.scene.pairs == want.scene.pairs == ((0, 0, 1, 0), (0, 1, 1, 0))
    assert len(got.imports) == len(got.scene.models) == 2
    for g, w, model, q0 in zip(got.imports, want.imports, got.scene.models, got.qpos0s):
        assert_imports_equal(g, w)
        assert model is g.model and q0 is g.qpos0
    arm = got.imports[0]
    assert arm.geom_names == ("tip_cap0", "tip_cap1")
    np.testing.assert_allclose(arm.model.geom_offset, [[0.4, 0.0, 0.0], [0.2, 0.0, 0.0]],
                               atol=1e-6)
    assert got.imports[1].model.free_base


@pytest.mark.parametrize(
    "xml, kwargs, match",
    [
        (FLOORLESS_PAIR_XML, {}, "force_contacts"),
        (TWO_TREES_XML, {}, "kinematic trees"),
        (FLUID_XML, {}, "fluid"),
        ("<mujoco/>", {}, "no jointed bodies"),
    ],
    ids=["floorless_pairs", "two_trees", "fluid", "no_joints"],
)
def test_refusals_match_jax(xml, kwargs, match):
    with pytest.raises(ValueError, match=match):
        jax_mjcf.from_mjcf(xml, **kwargs)
    with pytest.raises(ValueError, match=match):
        from_mjcf(xml, **kwargs)


def test_import_rules():
    """What the importer keeps and what it skips
    (tests/test_mjcf.py TestContactImportRules, TestFixedBaseArm)."""
    arm = from_mjcf(ARM_XML)
    assert arm.body_names == ("upper", "fore") and arm.model.n_bodies == 2
    np.testing.assert_allclose(arm.model.mass[1], 0.8 + 0.3)  # the weld merged
    toe = from_mjcf(TOE_XML)
    assert toe.has_ground and toe.geom_names == ("toe",)
    floorless = from_mjcf(FLOORLESS_TOE_XML)
    assert not floorless.has_ground and floorless.model.geom_radius.size == 0
    assert "toe" in floorless.skipped_geoms
    assert from_mjcf(PAIR_XML).model.pair_geom_b == (1,)
    assert from_mjcf(BALL_ON_FLOOR_XML).model.friction == pytest.approx(0.6)
    stacked = from_mjcf(STACKED_XML)
    assert stacked.body_names == ("sx", "body1")
    assert stacked.model.mass[0] == 0.0 and stacked.model.mass[1] == 1.0
    a1, a2 = from_mjcf(ACTUATOR_XML).actuators
    assert (a1.kind, a1.joint, a1.dof, a1.gear, a1.ctrlrange) == ("motor", "j1", 0, 20.0, (-1.0, 1.0))
    assert (a2.kind, a2.joint, a2.dof, a2.kp, a2.kv) == ("position", "j2", 1, 45.0, 2.5)
    spring = from_mjcf(SPRING_XML).model
    np.testing.assert_allclose(spring.spring_stiffness, [30.0])
    np.testing.assert_allclose(spring.spring_ref, [0.5])


# -- smooth dynamics against MuJoCo ---------------------------------------------------


def _mj_state(xml, qpos, qvel, tau):
    m = mujoco.MjModel.from_xml_string(xml)
    d = mujoco.MjData(m)
    d.qpos[:] = qpos
    d.qvel[:] = qvel
    d.qfrc_applied[:] = tau
    mujoco.mj_forward(m, d)
    M = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, d, M)
    return m, d, M


def f32(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def port_qacc(model, qpos, qvel, tau):
    return forward_dynamics(model, f32(qpos), f32(qvel), f32(tau))[0].numpy()


@pytest.mark.parametrize("name", ["fixed_base_arm", "joint_ref", "stacked_joints"])
def test_smooth_dynamics_match_mujoco(name):
    """Mass matrix and qacc of hinge / slide models at random states, a
    joint ref included (at qpos0 = ref too)."""
    xml = IMPORTS[name][0]
    imp = from_mjcf(xml)
    rng = np.random.RandomState(len(name))
    states = [rng.uniform(-1.0, 1.0, imp.model.nq) for _ in range(3)]
    if name == "joint_ref":
        states[0] = np.asarray(imp.qpos0, np.float64)
    for qpos in states:
        qvel = rng.uniform(-1.5, 1.5, imp.model.nv)
        tau = rng.uniform(-2.0, 2.0, imp.model.nv)
        _, d, M_mj = _mj_state(xml, qpos, qvel, tau)
        M = mass_matrix(imp.model, fwd_kinematics(imp.model, f32(qpos)))
        np.testing.assert_allclose(M.numpy(), M_mj, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(port_qacc(imp.model, qpos, qvel, tau), d.qacc,
                                   rtol=2e-4, atol=2e-3)


def test_free_base_dynamics_and_geometry_match_mujoco():
    """qacc of a free tree through the velocity and force conventions
    (MuJoCo [v_world, ω_body], the engine [ω_body, v_body]), and a contact
    sphere's world center."""
    imp = from_mjcf(FREE_TREE_XML)
    m = mujoco.MjModel.from_xml_string(FREE_TREE_XML)
    rng = np.random.RandomState(2)
    for _ in range(3):
        qpos = np.array(m.qpos0).copy()
        qpos[0:3] += 0.2 * rng.randn(3)
        quat = rng.randn(4)
        qpos[3:7] = quat / np.linalg.norm(quat)
        qpos[7:] = rng.uniform(-1.0, 1.0, size=m.nq - 7)
        qvel_mj = rng.uniform(-1.5, 1.5, size=m.nv)
        tau_mj = rng.uniform(-2.0, 2.0, size=m.nv)
        _, d, _ = _mj_state(FREE_TREE_XML, qpos, qvel_mj, tau_mj)
        E = fwd_kinematics(imp.model, f32(qpos)).E[0].numpy()
        tau = np.asarray(tau_mj, np.float64).copy()
        tau[0:3] = tau_mj[3:6]
        tau[3:6] = E.T @ tau_mj[0:3]
        qacc = port_qacc(imp.model, qpos, imp.qvel_from_mujoco(qpos, qvel_mj), tau)
        np.testing.assert_allclose(qacc, imp.qacc_from_mujoco(qpos, qvel_mj, d.qacc),
                                   rtol=5e-4, atol=5e-3)
    toe = from_mjcf(TOE_XML)
    m = mujoco.MjModel.from_xml_string(TOE_XML)
    d = mujoco.MjData(m)
    mujoco.mj_forward(m, d)
    kin = fwd_kinematics(toe.model, f32(toe.qpos0))
    center = engine.geom_world_centers(toe.model, kin)[0].numpy()
    g = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, "toe")
    np.testing.assert_allclose(center, d.geom_xpos[g], rtol=1e-5, atol=1e-5)


def test_ball_dofs_are_conjugated_as_mujoco_needs():
    imp = from_mjcf(BALL_FRAME_XML)
    assert len(imp.ball_dof_rotations) == 1
    rng = np.random.RandomState(7)
    quat = rng.randn(4)
    quat /= np.linalg.norm(quat)
    qvel_mj = rng.uniform(-1.0, 1.0, 3)
    _, d, _ = _mj_state(BALL_FRAME_XML, quat, qvel_mj, np.zeros(3))
    _, W_R = imp.ball_dof_rotations[0]
    qA = mjcf._mat_to_quat(W_R)
    qpos = mjcf._quat_mul(mjcf._quat_mul(qA, quat), qA * np.array([1.0, -1.0, -1.0, -1.0]))
    qacc = port_qacc(imp.model, qpos, imp.qvel_from_mujoco(qpos, qvel_mj), np.zeros(3))
    np.testing.assert_allclose(qacc, imp.qacc_from_mujoco(qpos, qvel_mj, d.qacc),
                               rtol=5e-4, atol=5e-3)


def test_spring_equilibrium_and_trajectory_match_mujoco():
    """The spring holds the hinge where MuJoCo settles it, and 150 steps of
    the passive arm follow ``mj_step`` (MuJoCo's Euler integrator is the
    engine's semi-implicit scheme with implicit joint damping)."""
    imp = from_mjcf(SPRING_XML)
    m = mujoco.MjModel.from_xml_string(SPRING_XML)
    m.opt.timestep = 0.002
    d = mujoco.MjData(m)
    for _ in range(4000):
        mujoco.mj_step(m, d)
    assert abs(port_qacc(imp.model, [d.qpos[0]], [0.0], [0.0])[0]) < 1e-3

    arm = from_mjcf(ARM_XML)
    m = mujoco.MjModel.from_xml_string(ARM_XML)
    m.opt.timestep = 0.002
    d = mujoco.MjData(m)
    rng = np.random.RandomState(5)
    d.qpos[:] = q0 = rng.uniform(-0.8, 0.8, 2)
    d.qvel[:] = v0 = rng.uniform(-1.0, 1.0, 2)
    qp, qv, zero = f32(q0), f32(v0), torch.zeros(2)
    for _ in range(150):
        mujoco.mj_step(m, d)
        qp, qv, _ = step(arm.model, qp, qv, zero, 0.002)
        np.testing.assert_allclose(qp.numpy(), d.qpos, atol=5e-5)


def test_imported_contacts_and_pairs_step():
    """A ball rests on the imported floor; the scene's capsule pushes the
    ball (tests/test_mjcf.py, through the port's step and scene_step)."""
    imp = from_mjcf(BALL_ON_FLOOR_XML, contact_stiffness=4_000.0, contact_damping=80.0)
    qpos, qvel, _ = step(imp.model, f32(imp.qpos0), torch.zeros(6), torch.zeros(6), 0.002,
                         n_substeps=600)
    assert 0.08 < float(qpos[2]) <= 0.101 and abs(float(qvel[5])) < 0.05
    scene = from_mjcf_scene(SCENE_XML)
    qposs = tuple(f32(q) for q in scene.qpos0s)
    qvels = (f32([-3.0]), torch.zeros(6))
    taus = (f32([-1.5]), torch.zeros(6))
    qposs, _, _ = scene_step(scene.scene, qposs, qvels, taus, 0.002, n_substeps=400)
    assert np.linalg.norm(qposs[1][0:2].numpy() - np.array([0.42, -0.2])) > 0.05


def _asset_dir(package, *parts):
    spec = importlib.util.find_spec(package)
    if spec is None or not spec.submodule_search_locations:
        pytest.skip(f"{package} is not installed")
    return os.path.join(spec.submodule_search_locations[0], *parts)


def _smooth_rel_error(m, imp, seed, n_states):
    """Largest relative qacc error of the port's engine against
    ``mj_forward`` with contacts and limits off on both sides."""
    model = dataclasses.replace(
        imp.model,
        joint_lower=np.full(imp.model.nv, -np.inf), joint_upper=np.full(imp.model.nv, np.inf),
        geom_body=(), geom_offset=np.zeros((0, 3)), geom_radius=np.zeros(0),
        pair_geom_a=(), pair_geom_b=(),
    )
    m.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_CONTACT | mujoco.mjtDisableBit.mjDSBL_LIMIT
    rng = np.random.RandomState(seed)
    worst = 0.0
    for _ in range(n_states):
        qpos = np.array(m.qpos0)
        for j in range(m.njnt):
            if int(m.jnt_type[j]) in (2, 3):
                qpos[int(m.jnt_qposadr[j])] += 0.3 * rng.randn()
        qvel_mj = 0.5 * rng.randn(m.nv)
        d = mujoco.MjData(m)
        d.qpos[:] = qpos
        d.qvel[:] = qvel_mj
        mujoco.mj_forward(m, d)
        qacc = port_qacc(model, qpos, imp.qvel_from_mujoco(qpos, qvel_mj), np.zeros(m.nv))
        expect = imp.qacc_from_mujoco(qpos, qvel_mj, d.qacc)
        worst = max(worst, float(np.max(np.abs(qacc - expect) / (1.0 + np.abs(expect)))))
    return worst


@pytest.mark.parametrize(
    "name, tol",
    [("ant", 1e-4), ("half_cheetah", 1e-4), ("hopper", 1e-4), ("walker2d", 1e-3),
     ("humanoid", 1e-2), ("point", 1e-4), ("inverted_pendulum", 1e-4)],
)
def test_gymnasium_robots_match_mujoco(name, tol):
    """The published gymnasium robots (free bases, welds, capsules, planar
    roots of stacked joints, springs) import and match mj_forward; the
    tolerances are tests/test_mjcf.py's."""
    path = _asset_dir("gymnasium", "envs", "mujoco", "assets", f"{name}.xml")
    imp = from_mjcf(path)
    rel = _smooth_rel_error(mujoco.MjModel.from_xml_path(path), imp, 0, 3)
    assert rel < tol, f"{name}: rel err {rel:.2e}"


@pytest.mark.parametrize(
    "name, tol",
    [("cartpole", 1e-4), ("pendulum", 1e-4), ("acrobot", 1e-4), ("cheetah", 1e-4),
     ("walker", 1e-3), ("hopper", 1e-3), ("reacher", 1e-4), ("humanoid", 1e-2)],
)
def test_dm_control_robots_match_mujoco(name, tol):
    path = _asset_dir("dm_control", "suite", f"{name}.xml")
    m = mujoco.MjModel.from_xml_path(path)
    rel = _smooth_rel_error(m, from_mjcf(m), 0, 2)
    assert rel < tol, f"{name}: rel err {rel:.2e}"


# -- legged_from_mjcf ----------------------------------------------------------------


def _wiring(env):
    return dict(kp=env.kp, action_scale=np.asarray(env.action_scale, np.float32),
                default_pose=np.asarray(env.default_pose, np.float32),
                stand_height=env.stand_height, n_feet=env.n_feet,
                damping=np.asarray(env.model.damping))


@pytest.mark.parametrize(
    "xml, kwargs",
    [
        (LEGGED_XML, dict(n_feet=2)),
        (LEGGED_XML.replace('<position joint="Lh" kp="50" kv="2" ctrlrange="-0.6 0.6"/>',
                            '<motor joint="Lh" gear="1" ctrlrange="-23.7 23.7"/>')
         .replace('<position joint="Rh" kp="50" kv="2" ctrlrange="-0.6 0.6"/>',
                  '<motor joint="Rh" gear="1" ctrlrange="-23.7 23.7"/>'), dict(kp=40.0)),
        (LEGGED_XML.split("<actuator>")[0] + "</mujoco>", dict(kp=40.0)),
        (mjcf_quadruped.QUADRUPED_MJCF,
         dict(default_pose=mjcf_quadruped.DEFAULT_POSE, stand_height=0.312)),
    ],
    ids=["position_actuators", "motor_ctrlranges", "no_actuators", "mjcf_quadruped"],
)
def test_legged_from_mjcf_wiring_matches_jax(xml, kwargs):
    """kp from the position actuators, kv folded into the damping, action
    scales from their ctrlranges (never from a motor's), the stand from
    qpos0 (nnx_ppo_tpu/envs/legged.py:45-160)."""
    got = _wiring(legged_from_mjcf(xml, **kwargs))
    want = _wiring(jax_legged_from_mjcf(xml, depthwise=False, **kwargs))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_legged_from_mjcf_stands_and_refuses_as_jax():
    env = legged_from_mjcf(LEGGED_XML, n_feet=2)
    assert env.kp == 50.0 and env._control_runner is not None
    np.testing.assert_allclose(env.model.damping[6:], [3.0, 3.0])  # 1.0 + kv 2.0
    np.testing.assert_allclose(env.action_scale.numpy(), [0.6, 0.6])
    assert env.stand_height == pytest.approx(0.4)
    state = env.reset(2, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for _ in range(25):  # 0.5 s of PD stand at the zero pose
        state = env.step(state, torch.zeros(2, 2), g)
    assert not state.done.any()
    assert bool(((state.data["qpos"][:, 2] > 0.3) & (state.data["qpos"][:, 2] < 0.45)).all())
    with pytest.raises(ValueError, match="kp"):
        legged_from_mjcf(LEGGED_XML.split("<actuator>")[0] + "</mujoco>")
    with pytest.raises(ValueError, match="free-base"):
        legged_from_mjcf(ARM_XML, kp=10.0)


def test_legged_from_mjcf_picks_up_an_hfield_terrain():
    m = hfield_model(LEGGED_HFIELD_XML, 0)
    env = legged_from_mjcf(m, kp=50.0, spawn_radius=2.0)
    assert isinstance(env.terrain, HeightGrid)
    np.testing.assert_array_equal(np.asarray(env.terrain.data),
                                  np.asarray(jax_mjcf.from_mjcf(m).terrain.data))
    state = env.reset(2, torch.Generator().manual_seed(0))
    state = env.step(state, torch.zeros(2, 2), torch.Generator().manual_seed(1))
    assert torch.isfinite(state.reward["tracking"]).all()


def test_imported_ant_stands():
    """gymnasium's ant through legged_from_mjcf (range-center pose, contact
    settings for its ~0.9 kg) stands 1 s under PD (tests/test_mjcf.py
    runs 2 s; an eager step of its 25 contact spheres takes 0.2 s here)."""
    path = _asset_dir("gymnasium", "envs", "mujoco", "assets", "ant.xml")
    imp = from_mjcf(path)
    lo, hi = imp.model.joint_lower[6:], imp.model.joint_upper[6:]
    env = legged_from_mjcf(
        path, kp=20.0, n_feet=4, reuse_mass_matrix=True,
        default_pose=np.where(np.isfinite(lo), 0.5 * (lo + hi), 0.0), stand_height=0.55,
        reset_joint_noise=0.02, min_height=0.2, contact_stiffness=800.0, contact_damping=30.0,
        model_overrides=dict(max_contact_force=100.0, friction_vel=0.3, limit_stiffness=300.0,
                             limit_damping=5.0),
    )
    state = env.reset(2, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for _ in range(50):
        state = env.step(state, torch.zeros(2, env.action_size), g)
    assert not state.done.any()
    assert bool(((state.data["qpos"][:, 2] > 0.3) & (state.data["qpos"][:, 2] < 0.7)).all())


# -- the saved MJCF quadruped ------------------------------------------------------


def test_saved_quadruped_import_equals_a_fresh_import():
    """physics/models/mjcf_quadruped.npz cannot go stale: it equals, field by
    field, a fresh import of the XML, which equals examples/mjcf_import.py's."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    try:
        import mjcf_import as example
    finally:
        sys.path.pop(0)
    assert mjcf_quadruped.QUADRUPED_MJCF == example.QUADRUPED_MJCF
    np.testing.assert_array_equal(mjcf_quadruped.DEFAULT_POSE, example.DEFAULT_POSE)
    fresh = from_mjcf(mjcf_quadruped.QUADRUPED_MJCF, **mjcf_quadruped.IMPORT_KWARGS)
    assert_imports_equal(mjcf_quadruped.load_quadruped_import(), fresh)


def test_saved_quadruped_builds_the_examples_env(tmp_path):
    """make_env on the saved import is legged_from_mjcf on the XML (JAX
    ``examples/mjcf_import.py::make_env``); save and load round-trip an
    import with a hfield and a rotated ball too."""
    env = mjcf_quadruped.make_env(reuse_mass_matrix=True)
    want = legged_from_mjcf(mjcf_quadruped.QUADRUPED_MJCF, default_pose=mjcf_quadruped.DEFAULT_POSE,
                            stand_height=0.312, reuse_mass_matrix=True)
    for key, value in _wiring(want).items():
        np.testing.assert_array_equal(_wiring(env)[key], value, err_msg=key)
    assert_models_equal(env.model, want.model)
    assert env._control_runner.kernel_spec == want._control_runner.kernel_spec
    assert env.kp == 60.0 and env.n_feet == 4 and env.action_size == 12
    for name in ("hfield", "ball_frame", "actuators"):
        xml, kwargs = source(name)
        imp = from_mjcf(xml, **kwargs)
        mjcf.save_import(imp, tmp_path / f"{name}.npz")
        assert_imports_equal(mjcf.load_import(tmp_path / f"{name}.npz"), imp)
