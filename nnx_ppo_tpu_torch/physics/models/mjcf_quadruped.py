"""The MJCF quadruped: a Go1-class robot in ordinary MJCF idiom, and its
saved import.

The port's own copy of ``examples/mjcf_import.py``'s ``QUADRUPED_MJCF``
(:61), ``DEFAULT_POSE`` (:110) and stand height 0.312 (:122): a
free-floating trunk, four legs of three hinges with joint anchors, foot
spheres, a ground plane and position actuators (kp 60, ctrlranges per
joint). ``benchmarks/suite.py``'s ``mjcf_quadruped_2048`` trains it.

``mjcf_quadruped.npz`` beside this file is ``from_mjcf(QUADRUPED_MJCF,
contact_stiffness=6000, contact_damping=120)`` (``legged_from_mjcf``'s
defaults) saved by ``physics/mjcf.py::save_import``, so that
:func:`make_env` builds the env where ``mujoco`` is not installed (the
GPU machine). ``tests/test_torch_mjcf.py`` holds the file equal, field by
field, to a fresh import. Regenerate it, where ``mujoco`` is installed,
with ``python -m nnx_ppo_tpu_torch.physics.models.mjcf_quadruped``.
"""

from __future__ import annotations

import os

import numpy as np

_LEG = """
      <body name="{leg}_hip" pos="{hx} {hy} 0">
        <joint name="{leg}_abd" type="hinge" axis="1 0 0" damping="2.0"
               armature="0.01"/>
        <inertial pos="0 {side_half} 0" mass="0.6"
                  diaginertia="0.0007 0.0007 0.0007"/>
        <body name="{leg}_thigh" pos="0 {side} 0">
          <joint name="{leg}_hip" type="hinge" axis="0 1 0" damping="2.0"
                 armature="0.01"/>
          <inertial pos="0 0 -0.1065" mass="0.9"
                    diaginertia="0.0035 0.0035 0.0002"/>
          <body name="{leg}_shank" pos="0 0 -0.213">
            <joint name="{leg}_knee" type="hinge" axis="0 1 0" damping="2.0"
                   armature="0.01"/>
            <inertial pos="0 0 -0.1065" mass="0.15"
                      diaginertia="0.0006 0.0006 0.00002"/>
            <geom name="{leg}_foot" type="sphere" size="0.022"
                  pos="0 0 -0.213" friction="0.8 0.005 0.0001"/>
          </body>
        </body>
      </body>
"""

QUADRUPED_MJCF = (
    """
<mujoco model="mjcf_quadruped">
  <option gravity="0 0 -9.81"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1"/>
    <body name="trunk" pos="0 0 0.312">
      <freejoint/>
      <inertial pos="0 0 0" mass="5.2" diaginertia="0.024 0.064 0.072"/>
"""
    + "".join(
        _LEG.format(
            leg=leg,
            hx=hx,
            hy=hy,
            side=0.08 if hy > 0 else -0.08,
            side_half=0.04 if hy > 0 else -0.04,
        )
        for leg, (hx, hy) in {
            "FR": (0.19, -0.05),
            "FL": (0.19, 0.05),
            "RR": (-0.19, -0.05),
            "RL": (-0.19, 0.05),
        }.items()
    )
    + """
    </body>
  </worldbody>
  <actuator>
"""
    + "".join(
        f'    <position joint="{leg}_{j}" kp="60" kv="0"'
        f' ctrlrange="{lo} {hi}"/>\n'
        for leg in ("FR", "FL", "RR", "RL")
        for j, (lo, hi) in (
            ("abd", (-0.5, 0.5)),
            ("hip", (0.3, 1.3)),
            ("knee", (-2.1, -1.1)),
        )
    )
    + """
  </actuator>
</mujoco>
"""
)

# The MJCF declares the model at q = 0 (legs straight); the standing
# crouch is a joint configuration, passed as the env's default pose.
DEFAULT_POSE = np.array([0.0, 0.8, -1.6] * 4)
STAND_HEIGHT = 0.312
# legged_from_mjcf's contact defaults, with which the import was saved.
IMPORT_KWARGS = dict(contact_stiffness=6_000.0, contact_damping=120.0)
IMPORT_PATH = os.path.join(os.path.dirname(__file__), "mjcf_quadruped.npz")


def load_quadruped_import():
    """The saved ``MjcfImport`` of :data:`QUADRUPED_MJCF`, without
    ``mujoco``."""
    from nnx_ppo_tpu_torch.physics.mjcf import load_import

    return load_import(IMPORT_PATH)


def make_env(**kwargs):
    """``LeggedJoystick`` on the saved import, as ``examples/mjcf_import.py::
    make_env`` builds it from the XML: kp and per-joint action scales from
    the position actuators, the standing crouch as the default pose."""
    from nnx_ppo_tpu_torch.envs.legged import legged_from_import

    return legged_from_import(
        load_quadruped_import(), default_pose=DEFAULT_POSE, stand_height=STAND_HEIGHT, **kwargs
    )


if __name__ == "__main__":
    from nnx_ppo_tpu_torch.physics.mjcf import from_mjcf, save_import

    save_import(from_mjcf(QUADRUPED_MJCF, **IMPORT_KWARGS), IMPORT_PATH)
    print(f"wrote {IMPORT_PATH}")
