"""nnx_ppo_tpu_torch.utils.profiling (port of nnx_ppo_tpu/utils/
profiling.py): ``trace`` writes a Chrome trace holding the training
step's spans, each once per call and inside its parent; the spans exist
only while a profiler runs, and leave a step's results unchanged to the
bit."""

import glob
import json

import pytest
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
DISTILL = DistillationConfig(n_envs=8, rollout_length=4, n_epochs=2, n_minibatches=2)


def _ppo_state(seed=0):
    env = EpisodeWrapper(CartpoleBalance(), 50)
    net = make_mlp_actor_critic(5, 1, [16], [16], 0, normalize_obs=True)
    optimizer = make_optimizer(CONFIG.learning_rate)
    return env, new_training_state(env, net, CONFIG.n_envs, seed, optimizer=optimizer,
                                   device="cpu"), optimizer


def _distillation_state(seed=0):
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    teacher = make_mlp_actor_critic(2, 2, [16], [16], 0, normalize_obs=False).eval()
    student = make_mlp_actor_critic(2, 2, [16], [16], 1, normalize_obs=False)
    optimizer = make_optimizer(DISTILL.learning_rate)
    state = new_distillation_state(env, teacher, student, DISTILL.n_envs, seed,
                                   optimizer=optimizer, device="cpu")
    return env, teacher, state, optimizer


def _step(kind):
    """A closure running one ``ppo_step`` or ``distillation_step`` on a
    fresh state."""
    if kind == "ppo_step":
        env, ts, optimizer = _ppo_state()
        return lambda: ppo_step(env, ts, CONFIG, optimizer)
    env, teacher, ds, optimizer = _distillation_state()
    return lambda: distillation_step(env, teacher, ds, DISTILL, optimizer)


def _annotations(log_dir):
    """``(name, start_us, end_us)`` of every range in the one Chrome trace
    under ``log_dir``."""
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"]


def test_trace_writes_each_range_once_per_call(tmp_path):
    ppo, distill = _step("ppo_step"), _step("distillation_step")
    with profiling.trace(str(tmp_path)) as prof:
        ppo()
        distill()
    names = [name for name, _, _ in _annotations(tmp_path)]
    assert {name: names.count(name) for name in RANGES} == {name: 1 for name in RANGES}
    # The profiler's own sums see them too.
    assert {e.key for e in prof.key_averages()} >= set(RANGES)


@pytest.mark.parametrize("kind", ["ppo_step", "distillation_step"])
def test_spans_inside_a_step_once_per_env_step_and_minibatch(tmp_path, kind):
    """T ``rollout.env`` (none in distillation's rollout) and E·M of each
    ``update.*``, each inside its parent's interval."""
    with profiling.trace(str(tmp_path)):
        _step(kind)()
    spans = _annotations(tmp_path)
    names = [name for name, _, _ in spans]
    em = CONFIG.n_epochs * CONFIG.n_minibatches
    assert em == DISTILL.n_epochs * DISTILL.n_minibatches == 4
    wanted = {"rollout.env": CONFIG.rollout_length if kind == "ppo_step" else 0,
              "update.loss": em, "update.backward": em, "update.optimizer": em}
    assert {name: names.count(name) for name in wanted} == wanted
    parents = {"rollout.env": "unroll_env", "unroll_env": "ppo_step", "ppo_update": "ppo_step",
               "update.loss": "ppo_update", "update.backward": "ppo_update",
               "update.optimizer": "ppo_update"}
    if kind == "distillation_step":
        parents = {child: "distillation_step" for child in wanted if child != "rollout.env"}
    for child, start, end in spans:
        if child in parents:
            assert any(name == parents[child] and s <= start and end <= e
                       for name, s, e in spans), (child, start, end)


def test_span_is_one_shared_no_op_without_a_profiler():
    assert profiling.span("ppo_step") is profiling.span("update.loss")
    with profiling.span("ppo_step") as entered:
        assert entered is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("ppo_step"), torch.profiler.record_function)


@pytest.mark.parametrize("kind", ["ppo_step", "distillation_step"])
def test_no_range_is_entered_without_a_profiler(tmp_path, monkeypatch, kind):
    def refuse(name):
        raise RuntimeError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    _step(kind)()
    # The same step under a profiler reaches the refusal.
    with pytest.raises(RuntimeError, match="entered"), profiling.trace(str(tmp_path)):
        _step(kind)()


def _assert_equal_trees(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_ppo_step_is_the_same_with_the_profiler_on_and_off(tmp_path):
    env, ts_off, optimizer = _ppo_state()
    _, ts_on, optimizer_on = _ppo_state()
    ts_off, m_off = ppo_step(env, ts_off, CONFIG, optimizer)
    with profiling.trace(str(tmp_path)):
        ts_on, m_on = ppo_step(env, ts_on, CONFIG, optimizer_on)
    _assert_equal_trees([ts_off.networks.state_dict(), ts_off.env_states,
                         ts_off.network_states, m_off],
                        [ts_on.networks.state_dict(), ts_on.env_states,
                         ts_on.network_states, m_on])
    assert torch.equal(ts_off.generator.get_state(), ts_on.generator.get_state())


def test_distillation_step_is_the_same_with_the_profiler_on_and_off(tmp_path):
    env, teacher, ds_off, optimizer = _distillation_state()
    _, _, ds_on, optimizer_on = _distillation_state()
    ds_off, m_off = distillation_step(env, teacher, ds_off, DISTILL, optimizer)
    with profiling.trace(str(tmp_path)):
        ds_on, m_on = distillation_step(env, teacher, ds_on, DISTILL, optimizer_on)
    _assert_equal_trees([ds_off.student.state_dict(), ds_off.env_states, ds_off.student_states,
                         ds_off.teacher_states, m_off],
                        [ds_on.student.state_dict(), ds_on.env_states, ds_on.student_states,
                         ds_on.teacher_states, m_on])
    assert torch.equal(ds_off.generator.get_state(), ds_on.generator.get_state())
