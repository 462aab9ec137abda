"""Articulated rigid-body physics of the port (``nnx_ppo_tpu/physics``):
the model description, terrain (analytic and data), domain randomization,
the SoA substep, the control-step, plane-sampler and substeps kernels,
the general-tree SoA dynamics with the scene control-step kernel, the
scene description, spatial algebra and the mass-matrix factor of the
generic engine. The rest of the generic engine (and ``scene_step`` on it),
the depth-wise engine and MJCF import are not ported yet."""

from nnx_ppo_tpu_torch.physics.model import BALL, FREE, HINGE, SLIDE, Model, ModelBuilder
from nnx_ppo_tpu_torch.physics.randomize import (
    DomainParams,
    DomainRandomization,
    privileged_vector,
)
from nnx_ppo_tpu_torch.physics.scene import Scene
from nnx_ppo_tpu_torch.physics.terrain import HeightGrid, Terrain, rough_terrain, stairs

__all__ = [
    "BALL",
    "DomainParams",
    "DomainRandomization",
    "FREE",
    "HINGE",
    "HeightGrid",
    "Model",
    "ModelBuilder",
    "SLIDE",
    "Scene",
    "Terrain",
    "privileged_vector",
    "rough_terrain",
    "stairs",
]
