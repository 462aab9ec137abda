"""Fake environments and networks for testing, batched (port of
``nnx_ppo_tpu/test_dummies``, with the same public names)."""

from nnx_ppo_tpu_torch.test_dummies.dict_obs_act_env import (
    DictObsActEnv,
    DictObsActNet,
    TwoArmEnv,
    TwoArmNet,
)
from nnx_ppo_tpu_torch.test_dummies.dummy_counter import DummyCounterEnv, DummyCounterNet
from nnx_ppo_tpu_torch.test_dummies.mock_env import MockEnv
from nnx_ppo_tpu_torch.test_dummies.move_from_center_env import MoveFromCenterEnv
from nnx_ppo_tpu_torch.test_dummies.move_to_center_env import MoveToCenterEnv
from nnx_ppo_tpu_torch.test_dummies.parrot_env import ParrotEnv
from nnx_ppo_tpu_torch.test_dummies.stateful_nets import RepeatAndCountNet

__all__ = [
    "DictObsActEnv",
    "DictObsActNet",
    "TwoArmEnv",
    "TwoArmNet",
    "MockEnv",
    "DummyCounterEnv",
    "DummyCounterNet",
    "MoveToCenterEnv",
    "MoveFromCenterEnv",
    "ParrotEnv",
    "RepeatAndCountNet",
]
