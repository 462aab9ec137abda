"""Articulated rigid-body physics of the port (``nnx_ppo_tpu/physics``):
the model description, the generic engine (CRBA + RNEA + penalty
contacts) and multi-tree scenes on it, MJCF import, terrain (analytic and
data), domain randomization, the SoA substep, the control-step,
plane-sampler and substeps kernels, the general-tree SoA dynamics with
the scene control-step kernel, the depth-wise engine and spatial
algebra."""

from nnx_ppo_tpu_torch.physics.engine import (
    bias_forces,
    forward_dynamics,
    fwd_kinematics,
    integrate,
    limit_torques,
    mass_matrix,
    step,
)
from nnx_ppo_tpu_torch.physics.engine_depthwise import (
    DepthPlan,
    forward_dynamics_dw,
    mass_matrix_dw,
    mass_matrix_factor_dw,
    mass_matrix_inverse_dw,
)
from nnx_ppo_tpu_torch.physics.mjcf import (
    ActuatorSpec,
    MjcfImport,
    MjcfSceneImport,
    from_mjcf,
    from_mjcf_scene,
)
from nnx_ppo_tpu_torch.physics.model import BALL, FREE, HINGE, SLIDE, Model, ModelBuilder
from nnx_ppo_tpu_torch.physics.randomize import (
    DomainParams,
    DomainRandomization,
    privileged_vector,
)
from nnx_ppo_tpu_torch.physics.scene import Scene, scene_forward, scene_step
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid, Terrain, rough_terrain, stairs

__all__ = [
    "ActuatorSpec",
    "BALL",
    "DepthPlan",
    "DomainParams",
    "DomainRandomization",
    "FREE",
    "HINGE",
    "HeightGrid",
    "MjcfImport",
    "MjcfSceneImport",
    "Model",
    "ModelBuilder",
    "SLIDE",
    "Scene",
    "Terrain",
    "bias_forces",
    "forward_dynamics",
    "forward_dynamics_dw",
    "from_mjcf",
    "from_mjcf_scene",
    "fwd_kinematics",
    "integrate",
    "limit_torques",
    "mass_matrix",
    "mass_matrix_dw",
    "mass_matrix_factor_dw",
    "mass_matrix_inverse_dw",
    "privileged_vector",
    "rough_terrain",
    "scene_forward",
    "scene_step",
    "stairs",
    "step",
]
