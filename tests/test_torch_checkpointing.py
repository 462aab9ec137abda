"""Checkpointing of the port (nnx_ppo_tpu_torch/algorithms/
checkpointing.py): the counterparts of tests/test_checkpointing.py (the
exact round trip, the AR1 NaN sentinel, architecture mismatch, same count
and different structure, the stored config, the cadence with step 0 and a
resume, the policy-only export), exact resume through both trainers, and
a policy saved by the JAX package's own ``save_checkpoint`` acting alike
in the port.

Exactness: a resumed run repeats the uninterrupted one's operations on
the same values in the same order on the CPU, so the two are held equal
to the bit. Against JAX: the restored policy's eval-mode actions at the
network parity tests' float32 tolerance, rtol 1e-5 / atol 1e-5.
"""

import dataclasses
import functools
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_networks import carried_across

from nnx_ppo_tpu.algorithms import PPOConfig as JaxPPOConfig
from nnx_ppo_tpu.algorithms import make_optimizer as jax_make_optimizer
from nnx_ppo_tpu.algorithms import new_training_state as jax_new_training_state
from nnx_ppo_tpu.algorithms.checkpointing import load_checkpoint as jax_load_checkpoint
from nnx_ppo_tpu.algorithms.checkpointing import save_checkpoint as jax_save_checkpoint
from nnx_ppo_tpu.algorithms.ppo import ppo_step as jax_ppo_step
from nnx_ppo_tpu.networks import make_mlp_actor_critic as jax_make_mlp_actor_critic
from nnx_ppo_tpu.test_dummies import MoveToCenterEnv as JaxMoveToCenterEnv
from nnx_ppo_tpu.wrappers import EpisodeWrapper as JaxEpisodeWrapper
from nnx_ppo_tpu_torch.algorithms import (
    CheckpointCallback,
    DistillationConfig,
    DistillationTrainConfig,
    EvalConfig,
    PPOConfig,
    TrainConfig,
    load_checkpoint,
    make_checkpoint_fn,
    make_optimizer,
    new_distillation_state,
    new_training_state,
    ppo_step,
    save_checkpoint,
    train_distillation,
    train_ppo,
)
from nnx_ppo_tpu_torch.algorithms.ppo import linear_schedule
from nnx_ppo_tpu_torch.core.struct import tree_flatten_with_path
from nnx_ppo_tpu_torch.envs import CartpoleBalance, QuadrupedJoystick
from nnx_ppo_tpu_torch.networks import (
    GRU,
    AR1VariationalBottleneck,
    Dense,
    NormalTanhSampler,
    PPOAdapter,
    Sequential,
    make_mlp,
    make_mlp_actor_critic,
)
from nnx_ppo_tpu_torch.physics import DomainRandomization
from nnx_ppo_tpu_torch.test_dummies import MoveToCenterEnv
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

CFG = PPOConfig(n_envs=8, rollout_length=4, n_epochs=2, n_minibatches=2)


def make_env_net(hidden=(16, 16)):
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    return env, make_mlp_actor_critic(2, 2, list(hidden), [16, 16], 0, normalize_obs=True)


def state_leaves(state):
    """(path, value) of everything a training state carries: tensors,
    the optimizer's state_dict, the generator's state and the counts."""
    out = []
    for path, leaf in tree_flatten_with_path(state):
        if isinstance(leaf, torch.optim.Optimizer):
            out.extend(tree_flatten_with_path(leaf.state_dict(), path))
        elif isinstance(leaf, torch.Generator):
            out.append((path, leaf.get_state()))
        else:
            out.append((path, leaf))
    return out


def assert_states_equal(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x.isnan(), y.isnan()), path
            assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), path
        else:
            assert x == y, path


class TestRoundTrip:
    def test_exact_state_roundtrip(self, tmp_path):
        env, net = make_env_net()
        optimizer = make_optimizer(CFG.learning_rate)
        ts = new_training_state(env, net, CFG.n_envs, seed=0, optimizer=optimizer, device="cpu")
        ts, _ = ppo_step(env, ts, CFG, optimizer)  # stats and moments nontrivial

        ckpt_fn = make_checkpoint_fn(str(tmp_path), config=None)
        assert isinstance(ckpt_fn, CheckpointCallback)
        ckpt_fn(ts, 32)
        step_dir = tmp_path / "step_0000000032"
        assert (step_dir / "metadata.pkl").exists()
        assert (step_dir / "state").exists()

        template = new_training_state(env, net, CFG.n_envs, seed=123, optimizer=optimizer,
                                      device="cpu")
        template, _ = ppo_step(env, template, CFG, optimizer)  # same structure, other values
        restored = load_checkpoint(str(step_dir), template)
        assert restored["step"] == 32
        assert restored["training_state"].networks is template.networks  # restored in place
        assert_states_equal(restored["training_state"], ts)

    def test_roundtrip_preserves_ar1_nan_sentinel(self, tmp_path):
        env = EpisodeWrapper(MoveToCenterEnv(), 50)
        g = torch.Generator().manual_seed(0)
        actor = Sequential.create([
            Dense.create(2, 8, g, torch.relu),
            AR1VariationalBottleneck.create(4),
            Dense.create(4, 4, g),
            NormalTanhSampler.create(),
        ])
        net = PPOAdapter.create(
            action=actor, value=make_mlp([2, 8, 1], g, activation_last_layer=False)
        )
        ts = new_training_state(env, net, 8, seed=0, device="cpu")
        assert torch.isnan(ts.network_states["action"][1]["last_z"]).all()  # fresh: all NaN
        make_checkpoint_fn(str(tmp_path))(ts, 0)
        template = new_training_state(env, net, 8, seed=9, device="cpu")
        template.network_states["action"][1]["last_z"].zero_()
        restored = load_checkpoint(str(tmp_path / "step_0000000000"), template)
        assert torch.isnan(restored["training_state"].network_states["action"][1]["last_z"]).all()
        assert_states_equal(restored["training_state"], ts)

    def test_architecture_mismatch_detected(self, tmp_path):
        env, net = make_env_net()
        ts = new_training_state(env, net, CFG.n_envs, seed=0, device="cpu")
        make_checkpoint_fn(str(tmp_path))(ts, 0)
        _, other_net = make_env_net(hidden=(16, 16, 16))
        other = new_training_state(env, other_net, CFG.n_envs, seed=0, device="cpu")
        with pytest.raises(ValueError, match="mismatch"):
            load_checkpoint(str(tmp_path / "step_0000000000"), other)
        # Same names, another width: the leaf's shape differs.
        _, wider = make_env_net(hidden=(16, 32))
        wider_ts = new_training_state(env, wider, CFG.n_envs, seed=0, device="cpu")
        with pytest.raises(ValueError, match="mismatch"):
            load_checkpoint(str(tmp_path / "step_0000000000"), wider_ts)

    def test_same_count_different_structure_raises(self, tmp_path):
        tree = {"weights": torch.ones(2, 3), "bias": torch.zeros(3)}
        save_checkpoint(str(tmp_path / "step_0"), tree, 0)
        renamed = {"weights": torch.ones(2, 3), "scale": torch.zeros(3)}
        with pytest.raises(ValueError, match="structure mismatch"):
            load_checkpoint(str(tmp_path / "step_0"), renamed)
        # By name, not by order: the same names in another order restore.
        reordered = {"bias": torch.full((3,), 5.0), "weights": torch.zeros(2, 3)}
        restored = load_checkpoint(str(tmp_path / "step_0"), reordered)["training_state"]
        assert torch.equal(restored["weights"], tree["weights"])
        assert torch.equal(restored["bias"], tree["bias"])

    def test_config_stored(self, tmp_path):
        env, net = make_env_net()
        ts = new_training_state(env, net, CFG.n_envs, seed=0, device="cpu")
        cfg = TrainConfig(ppo=CFG, seed=7)
        make_checkpoint_fn(str(tmp_path), config=cfg)(ts, 0)
        restored = load_checkpoint(str(tmp_path / "step_0000000000"), ts)
        assert restored["config"] == cfg and restored["config"].seed == 7

    def test_optimizer_entries_are_keyed_by_parameter_name(self, tmp_path):
        env, net = make_env_net()
        ts = new_training_state(env, net, CFG.n_envs, seed=0, device="cpu")
        save_checkpoint(str(tmp_path / "s"), ts, 0)
        with open(tmp_path / "s" / "metadata.pkl", "rb") as f:
            names = pickle.load(f)["leaf_names"]
        params = [name for name, _ in ts.networks.named_parameters()]
        assert params
        for name in params:
            for entry in ("step", "exp_avg", "exp_avg_sq"):
                assert f"opt_state.state.networks.{name}.{entry}" in names
        assert not any(n.startswith("opt_state.state.0.") for n in names)
        assert "opt_state.param_groups.0.update_count" in names
        assert {"generator", "steps_taken", "networks.layers.0.M2"} <= set(names)

    def test_a_generator_of_another_device_type_raises(self, tmp_path):
        """A CUDA generator's state (seed and offset) cannot set a CPU
        generator: a checkpoint that says it holds one refuses a CPU
        template, naming the device types."""
        env, net = make_env_net()
        ts = new_training_state(env, net, CFG.n_envs, seed=0, device="cpu")
        save_checkpoint(str(tmp_path / "s"), ts, 0)
        meta_path = tmp_path / "s" / "metadata.pkl"
        with open(meta_path, "rb") as f:
            metadata = pickle.load(f)
        assert metadata["generators"] == {"generator": "cpu"}
        metadata["generators"]["generator"] = "cuda"
        with open(meta_path, "wb") as f:
            pickle.dump(metadata, f)
        with pytest.raises(ValueError, match="device type mismatch"):
            load_checkpoint(str(tmp_path / "s"), ts)


class TestTrainLoopIntegration:
    def test_cadence_includes_step_zero_and_resume(self, tmp_path):
        env, net = make_env_net()
        cfg = TrainConfig(
            ppo=PPOConfig(n_envs=8, rollout_length=4, total_steps=128, n_epochs=1,
                          n_minibatches=1),
            eval=EvalConfig(enabled=False),
            checkpoint_every_steps=64,
        )
        res = train_ppo(env, net, cfg, checkpoint_fn=make_checkpoint_fn(str(tmp_path), cfg),
                        device="cpu")
        dirs = sorted(os.listdir(tmp_path))
        assert dirs == ["step_0000000000", "step_0000000064", "step_0000000128"]

        # Resume from the last checkpoint: continues to higher steps.
        template = new_training_state(env, net, cfg.ppo.n_envs, seed=0, device="cpu")
        restored = load_checkpoint(str(tmp_path / dirs[-1]), template)
        assert restored["training_state"].steps_taken == res.total_steps == 128
        res2 = train_ppo(env, net, cfg, total_steps=res.total_steps + 64,
                         initial_state=restored["training_state"], device="cpu")
        assert res2.total_steps > res.total_steps


def _cartpole_case():
    env = EpisodeWrapper(CartpoleBalance(), 50)
    net = make_mlp_actor_critic(5, 1, [16, 16], [32], 0, normalize_obs=True,
                                entropy_weight=1e-3)
    return env, net, PPOConfig(n_envs=8, rollout_length=4, n_epochs=2, n_minibatches=2)


def _gru_case():
    g = torch.Generator().manual_seed(0)
    net = PPOAdapter.create(
        action=Sequential.create([GRU.create(2, 8, g), Dense.create(8, 4, g),
                                  NormalTanhSampler.create()]),
        value=Sequential.create([GRU.create(2, 8, g), Dense.create(8, 1, g)]),
    )
    # Episodes of 6 steps: the carries reset inside the run.
    env = EpisodeWrapper(MoveToCenterEnv(), 6)
    return env, net, PPOConfig(n_envs=8, rollout_length=4, n_epochs=2, n_minibatches=2)


def _quadruped_case():
    from test_torch_legged import physics_net

    env = EpisodeWrapper(
        QuadrupedJoystick(
            reuse_mass_matrix=True, n_substeps=2, push_prob=0.3, push_force=50.0,
            command_resample_prob=0.2,
            randomize=DomainRandomization(mass_scale=(0.8, 1.2), friction=(0.4, 1.0),
                                          damping_scale=(0.9, 1.1), gain_scale=(0.9, 1.1)),
        ),
        max_len=500,
    )
    return env, physics_net(), PPOConfig(n_envs=4, rollout_length=3, n_epochs=2,
                                         n_minibatches=2, combine_advantages=True)


@pytest.mark.parametrize("case", [_cartpole_case, _gru_case, _quadruped_case],
                         ids=["flagship_shaped", "gru", "quadruped_dr_pushes"])
def test_resumed_train_ppo_equals_the_uninterrupted_run(tmp_path, case):
    """train_ppo for 2k iterations against k iterations, a checkpoint,
    a load into a fresh template (another seed) and k more: equal to the
    bit, weights, moments, carries, env states (DR draws, push draws,
    commands), generator and count. ``anneal_lr``: the resumed run's lr
    schedule continues from the restored ``update_count``."""
    k = 2
    env, net, ppo = case()
    per_iter = ppo.n_envs * ppo.rollout_length
    cfg = TrainConfig(ppo=dataclasses.replace(ppo, total_steps=2 * k * per_iter, anneal_lr=True,
                                              learning_rate=1e-3),
                      eval=EvalConfig(enabled=False), checkpoint_every_steps=k * per_iter, seed=3)
    whole = train_ppo(env, net, cfg, device="cpu").training_state

    # The first half with the whole run's schedule (its horizon is 2k).
    n_updates = 2 * k * ppo.n_epochs * ppo.n_minibatches
    first_optimizer = make_optimizer(linear_schedule(1e-3, 0.0, n_updates))
    train_ppo(env, net, cfg, total_steps=k * per_iter, optimizer=first_optimizer,
              checkpoint_fn=make_checkpoint_fn(str(tmp_path), cfg), device="cpu")
    template = new_training_state(env, net, ppo.n_envs, seed=99, device="cpu")
    restored = load_checkpoint(str(tmp_path / f"step_{k * per_iter:010d}"), template)
    assert restored["config"] == cfg
    group = restored["training_state"].opt_state.param_groups[0]
    assert group["update_count"] == k * ppo.n_epochs * ppo.n_minibatches
    resumed = train_ppo(env, net, cfg, initial_state=restored["training_state"],
                        device="cpu").training_state
    assert resumed.opt_state.param_groups[0]["lr"] < 1e-3 / 2  # annealed past half
    assert_states_equal(resumed, whole)


def test_resumed_train_distillation_equals_the_uninterrupted_run(tmp_path):
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    teacher = make_mlp_actor_critic(2, 2, [16], [16], 0, normalize_obs=True).eval()
    student = make_mlp_actor_critic(2, 2, [16], [16], 1, normalize_obs=True)
    dcfg = DistillationConfig(n_envs=8, rollout_length=4, total_steps=128, n_epochs=2,
                              n_minibatches=2, learning_rate=1e-3)
    cfg = DistillationTrainConfig(distillation=dcfg, eval=EvalConfig(enabled=False),
                                  checkpoint_every_steps=64)
    whole = train_distillation(env, teacher, student, cfg, device="cpu").training_state
    train_distillation(env, teacher, student, cfg, total_steps=64,
                       checkpoint_fn=make_checkpoint_fn(str(tmp_path)), device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["step_0000000000", "step_0000000064"]
    template = new_distillation_state(env, teacher, student, 8, seed=5, device="cpu")
    restored = load_checkpoint(str(tmp_path / "step_0000000064"), template)["training_state"]
    resumed = train_distillation(env, teacher, student, cfg, initial_state=restored,
                                 device="cpu").training_state
    assert_states_equal(resumed, whole)


class TestPolicyExport:
    def test_policy_only_roundtrip(self, tmp_path):
        """Saving just the network gives a deployment artifact without
        optimizer moments or env states; it restores into a freshly
        built module of the same architecture."""
        net = make_mlp_actor_critic(2, 2, [16], [16], 7, normalize_obs=True)
        save_checkpoint(str(tmp_path / "policy"), net, step=0)
        template = make_mlp_actor_critic(2, 2, [16], [16], 99, normalize_obs=True)
        loaded = load_checkpoint(str(tmp_path / "policy"), template)["training_state"]
        assert loaded is template
        for (na, a), (nb, b) in zip(net.state_dict().items(), loaded.state_dict().items()):
            assert na == nb and torch.equal(a, b)
        wrong = make_mlp_actor_critic(2, 2, [16, 16], [16], 1, normalize_obs=True)
        with pytest.raises(ValueError, match="mismatch"):
            load_checkpoint(str(tmp_path / "policy"), wrong)

    def test_a_policy_saved_by_jax_acts_alike_in_the_port(self, tmp_path):
        """The JAX package trains a make_mlp_actor_critic for one ppo_step,
        saves it policy-only with its own save_checkpoint (orbax) and
        restores it with its own load_checkpoint; its numpy leaves load
        into the port's module by name (convert.load_jax_leaves). The
        eval-mode actions on seeded observations agree at rtol = atol =
        1e-5 (float32 matmuls of width 16)."""
        jax_env = JaxEpisodeWrapper(JaxMoveToCenterEnv(), 50)
        jax_net = jax_make_mlp_actor_critic(2, 2, [16, 16], [16], jax.random.key(0),
                                            normalize_obs=True)
        jcfg = JaxPPOConfig(n_envs=8, rollout_length=4, n_epochs=1, n_minibatches=2)
        jopt = jax_make_optimizer(1e-3)
        jts = jax_new_training_state(jax_env, jax_net, 8, seed=0)
        jts, _ = jax.jit(functools.partial(jax_ppo_step, jax_env, config=jcfg,
                                           optimizer=jopt))(jts)
        trained = jts.networks
        jax_save_checkpoint(str(tmp_path / "policy"), trained, step=4)
        jax_template = jax_make_mlp_actor_critic(2, 2, [16, 16], [16], jax.random.key(5),
                                                 normalize_obs=True)
        restored = jax_load_checkpoint(str(tmp_path / "policy"), jax_template)
        assert restored["step"] == 4
        jax_policy = restored["training_state"]

        port = make_mlp_actor_critic(2, 2, [16, 16], [16], 3, normalize_obs=True)
        carried_across(jax_policy, port)
        obs = np.random.RandomState(0).randn(32, 2).astype(np.float32)
        want = jax_policy.eval()(jax_policy.initialize_state(32), obs).output.actions
        port.eval()
        got = port(port.initialize_state(32), torch.from_numpy(obs)).output.actions
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        # The normalizer's statistics moved in training and came across.
        assert float(port.layers[0].counter) > 0


def test_the_port_imports_neither_jax_nor_orbax(tmp_path):
    """With jax and orbax hidden, the package and every subpackage
    import, and a checkpoint saves and loads."""
    code = f"""
import sys
class Hide:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "orbax", "nnx_ppo_tpu"):
            raise ImportError("hidden")
sys.meta_path.insert(0, Hide())
import torch
import nnx_ppo_tpu_torch
from nnx_ppo_tpu_torch.algorithms import load_checkpoint, save_checkpoint
for name in nnx_ppo_tpu_torch.__all__:
    getattr(nnx_ppo_tpu_torch, name)
save_checkpoint({str(tmp_path / 's')!r}, {{"w": torch.ones(3)}}, 1)
out = load_checkpoint({str(tmp_path / 's')!r}, {{"w": torch.zeros(3)}})
assert bool((out["training_state"]["w"] == 1).all()) and out["step"] == 1
assert not any(m.split(".")[0] in ("jax", "orbax") for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
