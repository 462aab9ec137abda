"""Two-process data parallelism of nnx_ppo_tpu_torch on gloo (mirrors
``tests/test_multiprocess.py``, ``tests/test_parallel.py``'s sharded parity
and ``tests/test_checkpoint_topology.py``).

One pair of worker processes (rank 0 and 1, a ``FileStore`` in
``tmp_path``, one thread each, no JAX) runs every scenario; this process
computes the JAX references on its virtual CPU devices and exchanges
arrays with the workers through ``.npz`` files. A rank that fails fails
every test here.

* ``ppo_step`` at world size 2 against JAX's ``ppo_step`` on
  ``make_mesh(2)`` at E=2, M=4: the same converted weights, JAX's rollout
  injected (its draws cannot be made by a ``torch.Generator``), JAX's
  ``n_shards=2`` permutations. Parameters rtol 1e-4 / atol 2e-6 (8 adam
  steps, whose normalized updates amplify the float32 rounding of
  near-zero gradients, as in ``test_torch_ppo.py``); the rest as stated.
  The two ranks' parameters, moments, statistics and metrics are equal
  to the bit.
* The collectives of one step: per minibatch one gradient all-reduce and
  one all-gather of the advantage statistics (and the R² pieces), then
  one all-gather for the Normalizer and one for the metrics; none of
  them carries rollout data (the counterpart of JAX's
  ``TestNoCrossShardGathers``).
* ``distillation_step`` at world size 2 against the single process on the
  same injected rollout and plan.
* Checkpoints from world size 2 to 1 and from 1 to 2.
* The quadruped physics leg (the control step's plain version) at world
  size 2.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_networks import carried_across
from test_torch_ppo import port_transition

from nnx_ppo_tpu.algorithms import PPOConfig as JaxPPOConfig
from nnx_ppo_tpu.algorithms import make_optimizer as jax_make_optimizer
from nnx_ppo_tpu.algorithms import new_training_state as jax_new_training_state
from nnx_ppo_tpu.algorithms import rollout as jax_rollout
from nnx_ppo_tpu.algorithms.ppo import ppo_step as jax_ppo_step
from nnx_ppo_tpu.algorithms.types import LoggingLevel as JaxLoggingLevel
from nnx_ppo_tpu.core.struct import partition_params
from nnx_ppo_tpu.networks import make_mlp_actor_critic as jax_make_mlp_actor_critic
from nnx_ppo_tpu.parallel import make_mesh as jax_make_mesh
from nnx_ppo_tpu.parallel.permutation import minibatch_permutations as jax_permutations
from nnx_ppo_tpu.test_dummies import MoveToCenterEnv as JaxMoveToCenterEnv
from nnx_ppo_tpu.wrappers import EpisodeWrapper as JaxEpisodeWrapper
from nnx_ppo_tpu_torch.algorithms import (
    DistillationConfig,
    LoggingLevel,
    PPOConfig,
    load_checkpoint,
    make_optimizer,
    new_distillation_state,
    new_training_state,
    save_checkpoint,
)
from nnx_ppo_tpu_torch.algorithms import distillation as port_distillation
from nnx_ppo_tpu_torch.algorithms.ppo import ppo_step
from nnx_ppo_tpu_torch.core.struct import path_name, tree_flatten_with_path
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.parallel import minibatch_permutations
from nnx_ppo_tpu_torch.test_dummies import MoveToCenterEnv
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, E, M = 32, 4, 2, 4
LEVEL = JaxLoggingLevel.LOSSES | JaxLoggingLevel.CRITIC_EXTRA

_WORKER = r"""
import dataclasses
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
N, T, E, M = 32, 4, 2, 4

import nnx_ppo_tpu_torch.parallel.permutation as permutation
from nnx_ppo_tpu_torch.algorithms import (DistillationConfig, LoggingLevel, PPOConfig,
    load_checkpoint, make_optimizer, new_distillation_state, new_training_state,
    save_checkpoint)
from nnx_ppo_tpu_torch.algorithms import distillation, rollout
from nnx_ppo_tpu_torch.algorithms.ppo import ppo_step
from nnx_ppo_tpu_torch.core.struct import path_name, tree_flatten_with_path, tree_map
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.parallel import distributed_initialize, make_mesh
from nnx_ppo_tpu_torch.test_dummies import MoveToCenterEnv
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

distributed_initialize(backend="gloo", store=dist.FileStore(store, world), rank=rank,
                       world_size=world, timeout=datetime.timedelta(seconds=120))
mesh = make_mesh(world, device="cpu")
assert (mesh.rank, mesh.world_size, mesh.shape) == (rank, world, {"data": world})

CALLS = []
_all_reduce, _all_gather = dist.all_reduce, dist.all_gather


def counted_all_reduce(tensor, *args, **kwargs):
    CALLS.append((0, tensor.numel()))
    return _all_reduce(tensor, *args, **kwargs)


def counted_all_gather(parts, tensor, *args, **kwargs):
    CALLS.append((1, tensor.numel()))
    return _all_gather(parts, tensor, *args, **kwargs)


dist.all_reduce, dist.all_gather = counted_all_reduce, counted_all_gather


def filled(template, arrays, prefix):
    # The template's leaves from the global arrays by name, this rank's
    # block of the env axis (dim 1 of every [T, B, ...] rollout leaf).
    names = iter([path_name(p) for p, _ in tree_flatten_with_path(template)])

    def take(_):
        x = torch.from_numpy(arrays[prefix + next(names)])
        return x[:, mesh.block(x.shape[1])]

    return tree_map(take, template)


def net_state(net, arrays, prefix):
    net.load_state_dict({k[len(prefix):]: torch.from_numpy(arrays[k])
                         for k in arrays.files if k.startswith(prefix)})
    return net


def result(net, opt, metrics, **extra):
    out = {"net." + k: v.numpy() for k, v in net.state_dict().items()}
    for i, p in enumerate(net.parameters()):
        out[f"mu.{i}"] = opt.state[p]["exp_avg"].numpy()
        out[f"nu.{i}"] = opt.state[p]["exp_avg_sq"].numpy()
    out.update({"metric." + k: np.asarray(torch.as_tensor(v)) for k, v in metrics.items()})
    out.update(extra)
    return out


def ppo():
    a = np.load(work + "/ppo_in.npz")
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    net = net_state(make_mlp_actor_critic(2, 2, [16, 16], [16, 16], 0, normalize_obs=True),
                    a, "net.")
    cfg = PPOConfig(n_envs=N, rollout_length=T, n_epochs=E, n_minibatches=M,
                    logging_level=LoggingLevel.LOSSES | LoggingLevel.CRITIC_EXTRA)
    opt = make_optimizer(cfg.learning_rate)
    ts = new_training_state(env, net, N, seed=0, optimizer=opt, mesh=mesh)
    with torch.no_grad():
        _, _, template = rollout.unroll_env(env, ts.env_states, ts.networks,
                                            ts.network_states, T, torch.Generator())
    block = filled(dataclasses.replace(template, metrics={}), a, "rollout.")
    rollout.unroll_env = lambda *args: (ts.network_states, ts.env_states, block)
    permutation.minibatch_permutations = lambda *args: torch.from_numpy(a["selectors"]).long()
    CALLS.clear()
    ts, metrics = ppo_step(env, ts, cfg, opt, mesh)
    calls = np.asarray(CALLS)
    np.savez(f"{work}/ppo_{rank}.npz", **result(ts.networks, ts.opt_state, metrics, calls=calls,
             steps=np.asarray(ts.steps_taken), n_envs=np.asarray(ts.env_states.done.shape[0])))


def distill():
    a = np.load(work + "/distill_in.npz")
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    teacher = net_state(make_mlp_actor_critic(2, 2, [16], [16], 1), a, "teacher.").eval()
    student = net_state(make_mlp_actor_critic(2, 2, [16], [16], 2, normalize_obs=True), a,
                        "student.")
    cfg = DistillationConfig(n_envs=N, rollout_length=T, n_epochs=E, n_minibatches=M,
                             logging_level=LoggingLevel.LOSSES
                             | LoggingLevel.TRAIN_ROLLOUT_STATS)
    opt = make_optimizer(cfg.learning_rate)
    ds = new_distillation_state(env, teacher, student, N, seed=0, optimizer=opt, mesh=mesh)
    with torch.no_grad():
        *_, template = distillation.distillation_unroll_env(
            env, ds.env_states, teacher, ds.student, ds.student_states, ds.teacher_states, T,
            torch.Generator())
    block = filled(template, a, "rollout.")
    distillation.distillation_unroll_env = lambda *args: (
        ds.student_states, ds.teacher_states, ds.env_states, block)
    permutation.minibatch_permutations = lambda *args: torch.from_numpy(a["selectors"]).long()
    ds, metrics = distillation.distillation_step(env, teacher, ds, cfg, opt, mesh)
    np.savez(f"{work}/distill_{rank}.npz", **result(ds.student, ds.opt_state, metrics))


def checkpoints():
    # World size 2 to 1: one real step here, saved for the single process.
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    cfg = PPOConfig(n_envs=16, rollout_length=4, n_epochs=1, n_minibatches=2)
    opt = make_optimizer(cfg.learning_rate)
    net = make_mlp_actor_critic(2, 2, [16], [16], 0, normalize_obs=True)
    ts = new_training_state(env, net, 16, seed=0, optimizer=opt, mesh=mesh)
    ts, _ = ppo_step(env, ts, cfg, opt, mesh)
    save_checkpoint(work + "/ckpt_w2", ts, step=64, mesh=mesh)
    saved = {"obs": ts.env_states.obs.numpy(),
             **{"net." + k: v.numpy() for k, v in ts.networks.state_dict().items()}}
    # World size 1 to 2: the single process's checkpoint, into this rank.
    template = new_training_state(env, make_mlp_actor_critic(2, 2, [16], [16], 5,
                                                             normalize_obs=True),
                                  16, seed=3, optimizer=opt, mesh=mesh)
    restored = load_checkpoint(work + "/ckpt_w1", template, mesh=mesh)["training_state"]
    loaded = {"loaded_obs": restored.env_states.obs.clone().numpy(),
              **{"loaded." + k: v.clone().numpy() for k, v in restored.networks.state_dict().items()}}
    restored, metrics = ppo_step(env, restored, cfg, opt, mesh)
    np.savez(f"{work}/ckpt_{rank}.npz", **saved, **loaded,
             resumed_actor=np.asarray(metrics["losses/actor/mean"]),
             resumed_steps=np.asarray(restored.steps_taken),
             **{"resumed." + k: v.numpy() for k, v in restored.networks.state_dict().items()})


def physics():
    from nnx_ppo_tpu_torch.envs import QuadrupedJoystick
    from nnx_ppo_tpu_torch.networks import (Concat, Dense, NormalTanhSampler, Parallel,
                                            PPOAdapter, Sequential, make_mlp)
    from nnx_ppo_tpu_torch.physics import DomainRandomization
    from nnx_ppo_tpu_torch.physics.terrain import rough_terrain

    g = torch.Generator().manual_seed(0)
    enc = Concat.create(proprio=Dense.create(42, 16, g, torch.relu),
                        command=Dense.create(3, 8, g, torch.relu))
    actor = Sequential.create([Dense.create(24, 16, g, torch.relu), Dense.create(16, 24, g),
                               NormalTanhSampler.create(entropy_weight=1e-3)])
    critic = Parallel.create(
        tracking=make_mlp([24, 16, 1], g, activation_last_layer=False),
        penalty=make_mlp([24, 16, 1], g, activation_last_layer=False))
    net = Sequential.create([enc, PPOAdapter.create(action=actor, value=critic)])
    legged = QuadrupedJoystick(reuse_mass_matrix=True, randomize=DomainRandomization(),
                               push_prob=0.5, push_force=40.0, n_substeps=2,
                               terrain=rough_terrain(seed=2, amplitude=0.03, wavelength=1.5))
    assert legged._control_runner is not None
    env = EpisodeWrapper(legged, 500)
    cfg = PPOConfig(n_envs=8, rollout_length=2, n_epochs=1, n_minibatches=2,
                    combine_advantages=True)
    opt = make_optimizer(cfg.learning_rate)
    ts = new_training_state(env, net, 8, seed=0, optimizer=opt, mesh=mesh)
    ts, metrics = ppo_step(env, ts, cfg, opt, mesh)
    np.savez(f"{work}/physics_{rank}.npz", **result(ts.networks, ts.opt_state, metrics),
             qpos=ts.env_states.data["qpos"].numpy(), steps=np.asarray(ts.steps_taken))


ORIGINALS = (rollout.unroll_env, distillation.distillation_unroll_env,
             permutation.minibatch_permutations)
try:
    for scenario in (ppo, distill, checkpoints, physics):
        scenario()
        # Undo the injections of the scenario.
        (rollout.unroll_env, distillation.distillation_unroll_env,
         permutation.minibatch_permutations) = ORIGINALS
        print("DONE", scenario.__name__, flush=True)
finally:
    dist.destroy_process_group()
"""


def _save_tree(arrays, prefix, tree):
    for path, leaf in tree_flatten_with_path(tree):
        arrays[prefix + path_name(path)] = leaf.detach().numpy()


def _ppo_reference(work):
    """JAX's ppo_step on make_mesh(2), and the worker's inputs: the
    converted weights, JAX's rollout and its n_shards=2 permutations."""
    env = JaxEpisodeWrapper(JaxMoveToCenterEnv(), 50)
    jax_net = jax_make_mlp_actor_critic(2, 2, [16, 16], [16, 16], jax.random.key(0),
                                        normalize_obs=True)
    config = JaxPPOConfig(n_envs=N, rollout_length=T, n_epochs=E, n_minibatches=M,
                          logging_level=LEVEL)
    ts = jax_new_training_state(env, jax_net, N, seed=0)
    reset_key, perm_key, _ = jax.random.split(ts.rng_key, 3)
    _, _, rollout_data = jax.jit(jax_rollout.unroll_env, static_argnums=(0, 4))(
        env, ts.env_states, ts.networks, ts.network_states, T, reset_key)
    selectors = jax_permutations(perm_key, N, E, M, n_shards=2)
    mesh = jax_make_mesh(2)
    ts_mesh = jax_new_training_state(env, jax_net, N, seed=0, mesh=mesh)
    new_ts, metrics = jax.jit(jax_ppo_step, static_argnums=(0, 2, 3, 4))(
        env, ts_mesh, config, jax_make_optimizer(config.learning_rate), mesh)
    net = carried_across(jax_net, make_mlp_actor_critic(2, 2, [16, 16], [16, 16], 0,
                                                        normalize_obs=True))
    arrays = {"net." + k: v.numpy() for k, v in net.state_dict().items()}
    _save_tree(arrays, "rollout.", port_transition(rollout_data))
    arrays["selectors"] = np.asarray(selectors)
    np.savez(os.path.join(work, "ppo_in.npz"), **arrays)
    return new_ts, metrics, port_transition(rollout_data), np.asarray(selectors)


def _distill_inputs(work, monkeypatch):
    """A port dual rollout on the CPU, the plan, and the single-process
    distillation_step on them (the reference of the two-rank run)."""
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    teacher = make_mlp_actor_critic(2, 2, [16], [16], 1).eval()
    student = make_mlp_actor_critic(2, 2, [16], [16], 2, normalize_obs=True)
    arrays = {**{"teacher." + k: v.numpy() for k, v in teacher.state_dict().items()},
              **{"student." + k: v.numpy() for k, v in student.state_dict().items()}}
    cfg = DistillationConfig(n_envs=N, rollout_length=T, n_epochs=E, n_minibatches=M,
                             logging_level=LoggingLevel.LOSSES | LoggingLevel.TRAIN_ROLLOUT_STATS)
    opt = make_optimizer(cfg.learning_rate)
    ds = new_distillation_state(env, teacher, student, N, seed=0, optimizer=opt, device="cpu")
    with torch.no_grad():
        *_, rollout_data = port_distillation.distillation_unroll_env(
            env, ds.env_states, teacher, ds.student, ds.student_states, ds.teacher_states, T,
            torch.Generator().manual_seed(4))
    selectors = minibatch_permutations(torch.Generator().manual_seed(5), N, E, M, n_shards=2)
    _save_tree(arrays, "rollout.", rollout_data)
    arrays["selectors"] = selectors.numpy()
    np.savez(os.path.join(work, "distill_in.npz"), **arrays)
    import nnx_ppo_tpu_torch.parallel.permutation as permutation

    monkeypatch.setattr(port_distillation, "distillation_unroll_env", lambda *a: (
        ds.student_states, ds.teacher_states, ds.env_states, rollout_data))
    monkeypatch.setattr(permutation, "minibatch_permutations", lambda *a: selectors)
    ds, metrics = port_distillation.distillation_step(env, teacher, ds, cfg, opt)
    monkeypatch.undo()
    return ds, metrics


def _single_process_checkpoint(work):
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    cfg = PPOConfig(n_envs=16, rollout_length=4, n_epochs=1, n_minibatches=2)
    opt = make_optimizer(cfg.learning_rate)
    net = make_mlp_actor_critic(2, 2, [16], [16], 0, normalize_obs=True)
    ts = new_training_state(env, net, 16, seed=0, optimizer=opt, device="cpu")
    ts, _ = ppo_step(env, ts, cfg, opt)
    save_checkpoint(os.path.join(work, "ckpt_w1"), ts, step=64)
    return ts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario's references here, then one pair of ranks."""
    work = tmp_path_factory.mktemp("ranks")
    monkeypatch = pytest.MonkeyPatch()
    refs = {
        "ppo": _ppo_reference(str(work)),
        "distill": _distill_inputs(str(work), monkeypatch),
        "ckpt_w1": _single_process_checkpoint(str(work)),
    }
    script = work / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), "2",
                               str(work / "store"), str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    load = lambda name: [dict(np.load(work / f"{name}_{r}.npz")) for r in range(2)]  # noqa: E731
    return refs, {name: load(name) for name in ("ppo", "distill", "ckpt", "physics")}, work


def _assert_ranks_equal(results):
    r0, r1 = results
    assert r0.keys() == r1.keys()
    for key in r0:
        if not key.startswith(("calls", "qpos", "obs", "loaded_obs")):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


def _adam_moments(opt_state):
    adam = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
    return jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)


def test_two_rank_ppo_step_matches_jaxs_on_a_mesh_of_two(runs):
    """Tolerances: parameters rtol 1e-4 / atol 2e-6 (see the module
    docstring); adam's first moments rtol 1e-4 / atol 1e-7 and second
    moments rtol 1e-3 / atol 1e-12 (squares of gradients whose float32
    rounding differs: the ranks' halves are summed, JAX's whole minibatch
    reduced at once); Normalizer statistics rtol 1e-5 / atol 1e-6; metrics
    rtol 1e-4 / atol 1e-5."""
    refs, results, _ = runs
    new_ts, jax_metrics, _, _ = refs["ppo"]
    got = results["ppo"][0]
    params, rest = partition_params(new_ts.networks)
    mu, nu = _adam_moments(new_ts.opt_state)
    names = [name for name, _ in make_mlp_actor_critic(2, 2, [16, 16], [16, 16], 0,
                                                       normalize_obs=True).named_parameters()]
    assert len(names) == len(jax.tree.leaves(params)) == len(mu)
    for i, (name, want) in enumerate(zip(names, jax.tree.leaves(params))):
        np.testing.assert_allclose(got["net." + name], np.asarray(want), rtol=1e-4, atol=2e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got[f"mu.{i}"], np.asarray(mu[i]), rtol=1e-4, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(got[f"nu.{i}"], np.asarray(nu[i]), rtol=1e-3, atol=1e-12,
                                   err_msg=name)
    norm = rest.layers[0]
    np.testing.assert_allclose(got["net.layers.0.mean"], np.asarray(norm.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["net.layers.0.M2"], np.asarray(norm.M2), rtol=1e-5, atol=1e-6)
    assert float(got["net.layers.0.counter"]) == float(norm.counter) == N * T
    compared = 0
    for key, value in jax_metrics.items():
        if "metric." + key in got:
            np.testing.assert_allclose(got["metric." + key], np.asarray(value), rtol=1e-4,
                                       atol=1e-5, err_msg=key)
            compared += 1
    assert compared >= 8 and int(got["steps"]) == N * T and int(got["n_envs"]) == N // 2


def test_two_ranks_hold_the_same_bits(runs):
    """Parameters, optimizer moments, Normalizer statistics and metrics
    are equal to the bit on both ranks after a step (each path)."""
    for name in ("ppo", "distill", "physics"):
        _assert_ranks_equal(runs[1][name])


def test_collectives_per_step_and_no_rollout_data_crosses_ranks(runs):
    """Per minibatch one gradient all-reduce (every parameter, one
    buffer), then one all-gather of the advantage and R² statistics (4
    numbers each of 3 tensors); after the updates one all-gather for the
    metrics (4 per-update losses of E·M values, 4 numbers each of 2
    sampled tensors) and one for the Normalizer (count, mean and M2 of 2
    features); nothing else, and no gather as large as one rank's rollout
    of one leaf."""
    results = runs[1]["ppo"]
    n_params = sum(v.size for k, v in results[0].items()
                   if k.startswith("mu."))
    for r in results:
        calls = [tuple(c) for c in r["calls"]]
        reduces = [n for kind, n in calls if kind == 0]
        gathers = [n for kind, n in calls if kind == 1]
        assert reduces == [n_params] * (E * M)
        assert gathers == [12] * (E * M) + [4 * E * M + 2 * 4, 5]
        assert max(gathers) < T * (N // 2) * 2  # one rank's obs: [T, B/2, 2]
        assert [kind for kind, _ in calls[:2 * E * M]] == [1, 0] * (E * M)


def test_two_rank_distillation_step_equals_the_single_process(runs):
    """The same injected rollout and plan: student parameters rtol 1e-5 /
    atol 1e-6 (8 adam steps; the ranks' half-minibatch gradients averaged,
    against one reduction over the minibatch), Normalizer statistics and
    metrics rtol 1e-5 / atol 1e-6."""
    ds, metrics = runs[0]["distill"]
    got = runs[1]["distill"][0]
    for k, v in ds.student.state_dict().items():
        np.testing.assert_allclose(got["net." + k], v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metric." + k], np.asarray(torch.as_tensor(v)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_checkpoint_from_world_size_2_to_1(runs):
    """Saved by the two ranks (rank 0 writes after gathering the env
    states), restored into a single-process template: the weights to the
    bit, the env states the ranks' blocks in rank order, and training
    proceeds."""
    _, results, work = runs
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    cfg = PPOConfig(n_envs=16, rollout_length=4, n_epochs=1, n_minibatches=2)
    opt = make_optimizer(cfg.learning_rate)
    template = new_training_state(env, make_mlp_actor_critic(2, 2, [16], [16], 5,
                                                             normalize_obs=True),
                                  16, seed=3, optimizer=opt, device="cpu")
    restored = load_checkpoint(str(work / "ckpt_w2"), template)["training_state"]
    ranks = results["ckpt"]
    np.testing.assert_array_equal(restored.env_states.obs.numpy(),
                                  np.concatenate([r["obs"] for r in ranks]))
    for k, v in restored.networks.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ranks[0]["net." + k], err_msg=k)
    ts, metrics = ppo_step(env, restored, cfg, opt)
    assert torch.isfinite(metrics["losses/actor/mean"])
    assert ts.steps_taken == 2 * 16 * 4


def test_checkpoint_from_world_size_1_to_2(runs):
    """The single process's checkpoint restored into each rank's template:
    the weights to the bit, each rank's env-state block, and a step at
    world size 2 that leaves both ranks alike."""
    refs, results, _ = runs
    saved = refs["ckpt_w1"]
    obs = saved.env_states.obs.numpy()
    for rank, r in enumerate(results["ckpt"]):
        np.testing.assert_array_equal(r["loaded_obs"], obs[8 * rank:8 * (rank + 1)])
        for k, v in saved.networks.state_dict().items():
            np.testing.assert_array_equal(r["loaded." + k], v.numpy(), err_msg=k)
        assert np.isfinite(r["resumed_actor"]) and int(r["resumed_steps"]) == 2 * 16 * 4
    for key in results["ckpt"][0]:
        if key.startswith("resumed."):
            np.testing.assert_array_equal(results["ckpt"][0][key], results["ckpt"][1][key])


def test_physics_leg_runs_at_world_size_2(runs):
    """The quadruped with DR, pushes and rough terrain on the control
    step's plain version: one step at 2 x 4 envs, finite losses, the
    parameters equal on both ranks, each rank with its own envs."""
    r0, r1 = runs[1]["physics"]
    for key in ("metric.losses/actor/mean", "metric.losses/critic/tracking/mean"):
        assert np.isfinite(r0[key]), key
    assert r0["qpos"].shape == (4, 19) and not np.array_equal(r0["qpos"], r1["qpos"])
    assert int(r0["steps"]) == 8 * 2
