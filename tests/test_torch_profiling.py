"""nnx_ppo_tpu_torch.utils.profiling (port of nnx_ppo_tpu/utils/
profiling.py): ``trace`` writes a Chrome trace holding the training
step's ranges, ``Throughput`` counts env steps per second, and the
ranges leave a step's results unchanged to the bit."""

import glob
import json

import torch

from nnx_ppo_tpu_torch.algorithms import (
    DistillationConfig,
    PPOConfig,
    distillation_step,
    make_optimizer,
    new_distillation_state,
    new_training_state,
    ppo_step,
)
from nnx_ppo_tpu_torch.core.struct import tree_leaves
from nnx_ppo_tpu_torch.envs import CartpoleBalance
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.test_dummies import MoveToCenterEnv
from nnx_ppo_tpu_torch.utils import profiling
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

RANGES = ("ppo_step", "unroll_env", "ppo_update", "distillation_step")
CONFIG = PPOConfig(n_envs=8, rollout_length=4, n_epochs=2, n_minibatches=2)


def _ppo_state(seed=0):
    env = EpisodeWrapper(CartpoleBalance(), 50)
    net = make_mlp_actor_critic(5, 1, [16], [16], 0, normalize_obs=True)
    optimizer = make_optimizer(CONFIG.learning_rate)
    return env, new_training_state(env, net, CONFIG.n_envs, seed, optimizer=optimizer,
                                   device="cpu"), optimizer


def test_trace_writes_each_range_once_per_call(tmp_path):
    env, ts, optimizer = _ppo_state()
    denv = EpisodeWrapper(MoveToCenterEnv(), 50)
    teacher = make_mlp_actor_critic(2, 2, [16], [16], 0, normalize_obs=False).eval()
    student = make_mlp_actor_critic(2, 2, [16], [16], 1, normalize_obs=False)
    dcfg = DistillationConfig(n_envs=8, rollout_length=4, n_epochs=1, n_minibatches=2)
    dopt = make_optimizer(dcfg.learning_rate)
    ds = new_distillation_state(denv, teacher, student, 8, 0, optimizer=dopt, device="cpu")
    with profiling.trace(str(tmp_path)) as prof:
        ppo_step(env, ts, CONFIG, optimizer)
        distillation_step(denv, teacher, ds, dcfg, dopt)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    assert {name: names.count(name) for name in RANGES} == {name: 1 for name in RANGES}
    # The profiler's own sums see them too.
    assert {e.key for e in prof.key_averages()} >= set(RANGES)


def test_throughput_counts_steps_per_iter_times_ticks_over_elapsed(monkeypatch):
    clock = iter([10.0, 12.5])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    meter = profiling.Throughput(steps_per_iter=100)
    meter.start(torch.zeros(3))
    for _ in range(5):
        meter.tick()
    assert meter.stop({"x": torch.zeros(2), "y": [torch.ones(1)]}) == 100 * 5 / 2.5


def test_ppo_step_is_the_same_with_the_profiler_on_and_off(tmp_path):
    env, ts_off, optimizer = _ppo_state()
    _, ts_on, optimizer_on = _ppo_state()
    ts_off, m_off = ppo_step(env, ts_off, CONFIG, optimizer)
    with profiling.trace(str(tmp_path)):
        ts_on, m_on = ppo_step(env, ts_on, CONFIG, optimizer_on)
    for a, b in zip(tree_leaves([ts_off.networks.state_dict(), ts_off.env_states,
                                 ts_off.network_states, m_off]),
                    tree_leaves([ts_on.networks.state_dict(), ts_on.env_states,
                                 ts_on.network_states, m_on])):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert torch.equal(ts_off.generator.get_state(), ts_on.generator.get_state())
