"""Every public name of the JAX package's subpackages has its
counterpart in the port, or stands below as an absence by design or as
one still pending (none now), with its reason. Any other absence
fails."""

import importlib

import pytest

import nnx_ppo_tpu
import nnx_ppo_tpu_torch

SUBPACKAGES = ["algorithms", "core", "envs", "networks", "ops", "parallel", "physics",
               "test_dummies", "utils", "wrappers"]

# Names the port leaves out on purpose.
BY_DESIGN = {
    # The pytree partition helpers: the port's modules are nn.Modules,
    # whose parameters and buffers already are the partition.
    **{("core", name): "pytree partition helper; nn.Module parameters and buffers take its place"
       for name in ("combine", "field", "is_pytree_dataclass", "param_mask", "partition",
                    "partition_params", "pytree_dataclass", "static_field", "tree_set_attr")},
    ("ops", "gae_pallas"): "the Pallas GAE kernel's port is ops.gae.gae_per_key / gae_cuda "
                           "(csrc/gae.cu)",
}

# Names still to port, against their ROADMAP Queue 1 item: none (the
# parallel and physics names came with Queue 1 items 16 and 18).
PENDING: dict = {}


def test_the_root_imports_every_subpackage_of_jaxs_and_utils():
    assert set(nnx_ppo_tpu.__all__) <= set(nnx_ppo_tpu_torch.__all__)
    assert "utils" in nnx_ppo_tpu_torch.__all__
    for name in nnx_ppo_tpu_torch.__all__:
        assert getattr(nnx_ppo_tpu_torch, name).__name__ == f"nnx_ppo_tpu_torch.{name}"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_each_public_name_is_ported_or_listed(sub):
    jax_names = set(importlib.import_module(f"nnx_ppo_tpu.{sub}").__all__)
    port = importlib.import_module(f"nnx_ppo_tpu_torch.{sub}")
    absent = {name for name in jax_names if not hasattr(port, name)}
    listed = {name for (s, name) in {**BY_DESIGN, **PENDING} if s == sub}
    assert absent == listed, (
        f"unlisted absences {sorted(absent - listed)}; listed but present "
        f"{sorted(listed - absent)}"
    )
    for name in jax_names - absent:
        assert name in port.__all__, f"{sub}.{name} is defined but not exported"


def test_default_config_is_a_fresh_train_config():
    from nnx_ppo_tpu_torch.algorithms import TrainConfig, default_config

    assert default_config() == TrainConfig()
