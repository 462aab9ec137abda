from nnx_ppo_tpu_torch.physics.models.arm import make_arm
from nnx_ppo_tpu_torch.physics.models.humanoid import make_humanoid
from nnx_ppo_tpu_torch.physics.models.quadruped import make_quadruped

__all__ = ["make_arm", "make_humanoid", "make_quadruped"]
