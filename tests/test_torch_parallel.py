"""Data parallelism of nnx_ppo_tpu_torch in one process (mirrors
``tests/test_parallel.py``): the shard-local permutation structure, the
placement rule of ``shard_training_state`` / ``training_state_shardings``,
the mesh's refusals, and a world-size-1 gloo run of ``ppo_step`` (in a
subprocess) equal to the run without a mesh. The two-process runs are in
``test_torch_multiprocess.py``.

The permutations' draws cannot match JAX's threefry; their structure and
the unshuffled block slices are compared with the JAX package's exactly.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.parallel.permutation import minibatch_permutations as jax_minibatch_permutations
from nnx_ppo_tpu.parallel.permutation import minibatch_plan as jax_minibatch_plan
from nnx_ppo_tpu_torch.algorithms import new_training_state
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.parallel import (
    DATA_AXIS,
    batch_sharded,
    constrain_batch,
    constrain_time_batch,
    global_device_put,
    make_mesh,
    minibatch_permutations,
    minibatch_plan,
    replicated,
    shard_training_state,
    training_state_shardings,
)
from nnx_ppo_tpu_torch.parallel.mesh import Mesh, rank_generator
from nnx_ppo_tpu_torch.parallel.permutation import shard_local_selectors
from nnx_ppo_tpu_torch.test_dummies import MoveToCenterEnv
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_mesh(rank, world_size):
    """A mesh object for the placement rules (no process group: nothing
    here runs a collective)."""
    return Mesh(group=None, rank=rank, world_size=world_size, device=torch.device("cpu"),
                backend="gloo")


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


class TestMinibatchPermutations:
    def test_single_shard_is_full_permutation(self):
        inds = minibatch_permutations(gen(), 16, 3, 4, n_shards=1)
        assert inds.shape == (12, 4)
        for e in range(3):
            np.testing.assert_array_equal(np.sort(inds[e * 4:(e + 1) * 4].numpy().ravel()),
                                          np.arange(16))

    def test_sharded_stays_block_local(self):
        n_envs, shards, M = 32, 4, 2
        inds = minibatch_permutations(gen(), n_envs, 2, M, n_shards=shards)
        per_shard, k = n_envs // shards, n_envs // shards // M
        for row in inds.numpy():
            for s in range(shards):
                chunk = row[s * k:(s + 1) * k]
                assert ((chunk >= s * per_shard) & (chunk < (s + 1) * per_shard)).all()

    def test_sharded_covers_all_envs_per_epoch(self):
        inds = minibatch_permutations(gen(1), 32, 1, 4, n_shards=4)
        np.testing.assert_array_equal(np.sort(inds.numpy().ravel()), np.arange(32))

    def test_epochs_differ(self):
        inds = minibatch_permutations(gen(), 64, 2, 1, n_shards=1)
        assert not torch.equal(inds[0], inds[1])

    @pytest.mark.parametrize("args", [(10, 1, 4), (12, 1, 4, 8), (16, 1, 4, 8)])
    def test_divisibility_errors_are_jaxs(self, args):
        with pytest.raises(ValueError) as want:
            jax_minibatch_permutations(jax.random.key(0), *args)
        with pytest.raises(ValueError) as got:
            minibatch_permutations(gen(), *args)
        assert str(got.value) == str(want.value)

    def test_the_structure_is_jaxs(self):
        """Every row takes k indices of each shard block in turn, and each
        epoch covers every env once, on both sides."""
        jax_inds = np.asarray(jax_minibatch_permutations(jax.random.key(3), 48, 2, 3, n_shards=4))
        inds = minibatch_permutations(gen(3), 48, 2, 3, n_shards=4).numpy()
        assert inds.shape == jax_inds.shape
        k = inds.shape[1] // 4
        for x in (inds, jax_inds):
            blocks = x.reshape(2, 3, 4, k) // 12  # the shard block of every index
            np.testing.assert_array_equal(blocks, np.broadcast_to(np.arange(4)[:, None],
                                                                  blocks.shape))
            for e in range(2):
                np.testing.assert_array_equal(np.sort(x[e * 3:(e + 1) * 3].ravel()),
                                              np.arange(48))


def test_shard_local_selectors_index_each_ranks_block():
    sel = minibatch_permutations(gen(5), 24, 2, 2, n_shards=3)
    for rank in range(3):
        local = shard_local_selectors(sel, 24, 3, rank)
        assert local.shape == (4, 4) and local.min() >= 0 and local.max() < 8
        np.testing.assert_array_equal(local.numpy() + 8 * rank, sel[:, 4 * rank:4 * rank + 4])


@pytest.mark.parametrize("batch_major", [False, True])
def test_unshuffled_shard_blocks_match_jax(batch_major):
    """``shuffle=False`` with shards: minibatch m takes rows [m·k, (m+1)·k)
    of every shard block (JAX ``permutation.py:137-168``), to the bit."""
    x = np.random.RandomState(0).randn(24, 5, 3).astype(np.float32)  # [B, T, f]
    seq = x if batch_major else x.transpose(1, 0, 2)
    jax_sel, jax_seq, jax_batch = jax_minibatch_plan(24, 2, 2, 3, shuffle=False,
                                                     batch_major=batch_major)
    sel, take_seq, take_batch = minibatch_plan(24, 2, 2, 3, shuffle=False,
                                               batch_major=batch_major)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jax_sel))
    for m in range(2):
        np.testing.assert_array_equal(take_seq(torch.from_numpy(seq), m).numpy(),
                                      np.asarray(jax_seq(seq, m)))
        np.testing.assert_array_equal(take_batch(torch.from_numpy(x), m).numpy(),
                                      np.asarray(jax_batch(x, m)))
    for args in ((24, 1, 4, 4), (24, 1, 2, 5)):
        with pytest.raises(ValueError) as want:
            jax_minibatch_plan(*args, shuffle=False)
        with pytest.raises(ValueError) as got:
            minibatch_plan(*args, shuffle=False)
        assert str(got.value) == str(want.value)


def _state(n_envs=32):
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    net = make_mlp_actor_critic(2, 2, [16], [16], 0)
    return new_training_state(env, net, n_envs, seed=0, device="cpu")


def test_state_shardings_follow_the_leaf_rule():
    """Env-batched leaves are batched, a leaf whose dim 0 the world size
    does not divide (and every scalar) replicated, the rest replicated
    (JAX ``mesh.py:58-93``)."""
    ts = _state()
    ts = ts.replace(env_states=ts.env_states.replace(
        info={"table": torch.arange(6.0), "scale": torch.tensor(2.0)}))
    sh = training_state_shardings(ts, cpu_mesh(0, 4))
    assert sh.env_states.obs.batched and sh.env_states.done.batched
    assert not sh.env_states.info["table"].batched  # 6 % 4 != 0
    assert not sh.env_states.info["scale"].batched
    for name in ("networks", "opt_state", "generator", "steps_taken"):
        assert getattr(sh, name) == replicated(cpu_mesh(0, 4)), name
    assert batch_sharded(cpu_mesh(0, 4), DATA_AXIS).batched


def test_shard_training_state_keeps_each_ranks_block():
    """Every rank builds the full state from the seed and keeps its block:
    the blocks in rank order are the single-process state row for row."""
    ts = _state()
    blocks = [shard_training_state(ts, cpu_mesh(r, 4)) for r in range(4)]
    for b in blocks:
        assert b.env_states.obs.shape == (8, 2) and b.networks is ts.networks
    torch.testing.assert_close(torch.cat([b.env_states.obs for b in blocks]),
                               ts.env_states.obs, rtol=0, atol=0)
    x = torch.arange(12.0).reshape(4, 3)
    torch.testing.assert_close(global_device_put(x, batch_sharded(cpu_mesh(3, 4))), x[3:],
                               rtol=0, atol=0)
    assert torch.equal(global_device_put(x, replicated(cpu_mesh(3, 4))), x)


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    for n in (2, None):
        with pytest.raises(RuntimeError, match="distributed_initialize"):
            make_mesh(n)


def test_constrain_raises_on_a_global_shaped_leaf():
    mesh = cpu_mesh(1, 2)
    local = {"obs": torch.zeros(4, 3), "scalar": torch.tensor(1.0), "odd": torch.zeros(5)}
    assert constrain_batch(local, mesh, n_envs=8) is local
    assert constrain_batch(torch.zeros(8, 3), None) is not None  # no mesh: nothing checked
    with pytest.raises(ValueError, match="holds 8 envs along axis 0"):
        constrain_batch({"obs": torch.zeros(8, 3)}, mesh, n_envs=8)
    assert constrain_time_batch(torch.zeros(6, 4, 3), mesh, n_envs=8) is not None
    with pytest.raises(ValueError, match="holds 8 envs along axis 1"):
        constrain_time_batch(torch.zeros(6, 8, 3), mesh, n_envs=8)


def test_rank_generators_are_the_one_generator_at_world_size_1_and_differ_above():
    g = gen(7)
    assert rank_generator(g, None) is g and rank_generator(g, cpu_mesh(0, 1)) is g
    draws, after = [], []
    for rank in range(2):
        g = gen(7)  # the replicated generator: the same state on every rank
        draws.append(torch.rand(4, generator=rank_generator(g, cpu_mesh(rank, 2))))
        after.append(torch.rand(3, generator=g))
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(after[0], after[1])  # the replicated stream moves on alike


_W1_WORKER = r"""
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from nnx_ppo_tpu_torch.algorithms import LoggingLevel, PPOConfig, make_optimizer, new_training_state
from nnx_ppo_tpu_torch.algorithms.ppo import ppo_step
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.parallel import distributed_initialize, make_mesh
from nnx_ppo_tpu_torch.test_dummies import MoveToCenterEnv
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


def run(mesh, layout):
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    net = make_mlp_actor_critic(2, 2, [16, 16], [16, 16], 0, normalize_obs=True)
    cfg = PPOConfig(n_envs=32, rollout_length=6, n_epochs=2, n_minibatches=4,
                    logging_level=LoggingLevel.ALL, rollout_layout=layout)
    opt = make_optimizer(cfg.learning_rate)
    ts = new_training_state(env, net, 32, seed=0, optimizer=opt, device="cpu", mesh=mesh)
    for _ in range(2):
        ts, metrics = ppo_step(env, ts, cfg, opt, mesh)
    return ts, metrics


distributed_initialize(backend="gloo", store=dist.FileStore(sys.argv[1], 1), rank=0,
                       world_size=1)
try:
    mesh = make_mesh(device="cpu")
    assert mesh.world_size == 1 and mesh.shape == {"data": 1}
    for layout in ("time_major", "batch_major"):
        ts0, m0 = run(None, layout)
        ts1, m1 = run(mesh, layout)
        for (name, a), b in zip(ts0.networks.state_dict().items(),
                                ts1.networks.state_dict().values()):
            assert torch.equal(a, b), name
        for k in m0:
            assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
        assert torch.equal(ts0.env_states.obs, ts1.env_states.obs)
        assert ts0.steps_taken == ts1.steps_taken == 2 * 32 * 6
        print("EQUAL", layout, len(m0), flush=True)
finally:
    dist.destroy_process_group()
"""


def test_world_size_1_gloo_ppo_step_equals_the_run_without_a_mesh(tmp_path):
    """``ppo_step(mesh=make_mesh())`` at world size 1 (gloo; every
    collective runs, on one rank) equals the run without a mesh to the
    bit: parameters, Normalizer statistics, every metric of
    ``LoggingLevel.ALL`` and the env states, two steps, both layouts."""
    script = tmp_path / "w1_worker.py"
    script.write_text(_W1_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "store")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("EQUAL") == 2, out.stdout
