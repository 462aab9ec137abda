"""Distillation of nnx_ppo_tpu_torch against nnx_ppo_tpu's (mirrors
``tests/test_distillation.py``): the loss in its three replays, one
update phase against JAX's ``distillation_step``, the frozen teacher, the
student's NLL falling on the CPU, and ``train_distillation``'s loop.

The JAX package makes the rollouts (its draws cannot be reproduced by a
torch.Generator); rollout, carries and weights are carried across as
numpy. Tolerance: float32 rtol 1e-5 / atol 1e-6 (the same sums reduced in
another order), unless a test says why otherwise.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_networks import carried_across, np_leaves

from nnx_ppo_tpu.algorithms import DistillationConfig as JaxDistillationConfig
from nnx_ppo_tpu.algorithms import make_optimizer as jax_make_optimizer
from nnx_ppo_tpu.algorithms import new_distillation_state as jax_new_distillation_state
from nnx_ppo_tpu.algorithms.distillation import DistillationMinibatch as JaxDistillationMinibatch
from nnx_ppo_tpu.algorithms.distillation import distillation_loss as jax_distillation_loss
from nnx_ppo_tpu.algorithms.distillation import distillation_step as jax_distillation_step
from nnx_ppo_tpu.algorithms.distillation import (
    distillation_unroll_env as jax_distillation_unroll_env,
)
from nnx_ppo_tpu.algorithms.types import LoggingLevel as JaxLoggingLevel
from nnx_ppo_tpu.core.struct import partition_params
from nnx_ppo_tpu.envs import CartpoleBalance as JaxCartpoleBalance
from nnx_ppo_tpu.networks import make_mlp_actor_critic as jax_make_mlp_actor_critic
from nnx_ppo_tpu.parallel.permutation import minibatch_permutations
from nnx_ppo_tpu.wrappers import EpisodeWrapper as JaxEpisodeWrapper
from nnx_ppo_tpu_torch.algorithms import (
    DistillationConfig,
    DistillationTrainConfig,
    DistillationTransition,
    EvalConfig,
    LoggingLevel,
    VideoConfig,
    default_distillation_config,
    distillation_loss,
    distillation_step,
    distillation_unroll_env,
    distillation_update,
    make_optimizer,
    new_distillation_state,
    train_distillation,
)
from nnx_ppo_tpu_torch.algorithms.distillation import DistillationMinibatch
from nnx_ppo_tpu_torch.convert import to_torch
from nnx_ppo_tpu_torch.networks import PPONetworkOutput, make_mlp_actor_critic
from nnx_ppo_tpu_torch.test_dummies import MoveToCenterEnv
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)

N_ENVS, T = 8, 5
TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(n_envs=N_ENVS, rollout_length=T, n_epochs=2, n_minibatches=2, learning_rate=1e-3)


def jax_pair(obs=5, act=1):
    """A teacher with distinctive means (initializer_scale 3, eval mode)
    and a student with an entropy bonus (its regularization is kept);
    both normalize their obs (the trees of carries and extras must be
    isomorphic)."""
    teacher = jax_make_mlp_actor_critic(
        obs, act, [16, 16], [16], jax.random.key(0), normalize_obs=True, entropy_weight=0.0,
        initializer_scale=3.0,
    ).eval()
    student = jax_make_mlp_actor_critic(
        obs, act, [16, 16], [16], jax.random.key(99), normalize_obs=True, entropy_weight=1e-2,
    )
    return teacher, student


def port_pair(obs=5, act=1, jax_teacher=None, jax_student=None):
    teacher = make_mlp_actor_critic(obs, act, [16, 16], [16], 0, normalize_obs=True,
                                    entropy_weight=0.0, initializer_scale=3.0)
    student = make_mlp_actor_critic(obs, act, [16, 16], [16], 1, normalize_obs=True,
                                    entropy_weight=1e-2)
    if jax_teacher is not None:
        carried_across(jax_teacher, teacher)
        carried_across(jax_student, student)
    return teacher.eval(), student


def port_distillation_transition(tr) -> DistillationTransition:
    tr = np_leaves(tr)
    out = tr.student_output
    return DistillationTransition(
        obs=to_torch(tr.obs),
        student_output=PPONetworkOutput(to_torch(out.actions), to_torch(out.loglikelihoods),
                                        to_torch(out.value_estimates)),
        rewards=to_torch(tr.rewards),
        done=to_torch(tr.done),
        truncated=to_torch(tr.truncated),
        next_obs=to_torch(tr.next_obs),
        metrics={},
        student_rollout_extras=to_torch(tr.student_rollout_extras),
        teacher_rollout_extras=to_torch(tr.teacher_rollout_extras),
    )


@pytest.fixture(scope="module")
def jax_setup():
    """A JAX distillation state on the cart-pole (4-step time limit:
    resets inside T), the dual rollout its first distillation_step makes,
    and that step's minibatch selectors."""
    env = JaxEpisodeWrapper(JaxCartpoleBalance(), max_len=4)
    teacher, student = jax_pair()
    config = JaxDistillationConfig(**CFG)
    state = jax_new_distillation_state(env, teacher, student, N_ENVS, seed=0,
                                       learning_rate=config.learning_rate)
    reset_key, new_key = jax.random.split(state.rng_key)
    unroll = jax.jit(functools.partial(jax_distillation_unroll_env, env, teacher=teacher,
                                       unroll_length=T))
    _, _, _, rollout_data = unroll(state.env_states, student=state.student,
                                   student_state=state.student_states,
                                   teacher_state=state.teacher_states,
                                   rng_key_for_env_reset=reset_key)
    selectors = minibatch_permutations(new_key, N_ENVS, config.n_epochs, config.n_minibatches)
    return env, teacher, config, state, rollout_data, np.asarray(selectors)


def test_dual_rollout_records_the_teachers_mean_and_resets(jax_setup):
    """The JAX rollout the tests use: resets inside T, and the teacher's
    stored raw action is its mean (eval mode), which the student's
    sampled action is not."""
    _, teacher, _, state, rollout_data, _ = jax_setup
    assert bool(rollout_data.done.any())
    raw = rollout_data.teacher_rollout_extras[1]["action"][-1]["raw_action"]
    mean = teacher(teacher.initialize_state(N_ENVS), rollout_data.obs[0]).output.actions
    np.testing.assert_allclose(np.tanh(np.asarray(raw[0])), np.asarray(mean), **TOL)
    student_raw = rollout_data.student_rollout_extras[1]["action"][-1]["raw_action"]
    assert not np.allclose(np.asarray(student_raw), np.asarray(raw))


@pytest.mark.parametrize("replay", ["batch_major", "fused", "unfused"])
def test_distillation_loss_and_gradients_match_jax(jax_setup, replay):
    """The NLL of the teacher's stored action under the student, fed the
    teacher's extras, plus the student's entropy bonus: JAX's
    distillation_loss against the port's in each replay. rtol 1e-5 / atol
    1e-6 on the loss and its metrics; gradients rtol 1e-4 / atol 1e-6
    (float32 sums of T·B products in another order reach 2e-5 of an
    entry)."""
    _, teacher, _, state, rollout_data, _ = jax_setup
    batch_major = replay == "batch_major"
    fused = replay != "unfused"
    level = JaxLoggingLevel.LOSSES
    params, rest = partition_params(state.student)
    view = JaxDistillationMinibatch.from_rollout(rollout_data, batch_major)

    def loss_fn(p):
        return jax_distillation_loss(p, rest, state.student_states, view, level,
                                     fused_replay=fused)

    (jax_loss, jax_metrics), jax_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    _, student = port_pair(jax_teacher=teacher, jax_student=state.student)
    port_view = DistillationMinibatch.from_rollout(port_distillation_transition(rollout_data),
                                                   batch_major)
    loss, metrics = distillation_loss(student, student.initialize_state(N_ENVS), port_view,
                                      LoggingLevel.LOSSES, fused_replay=fused)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_loss), **TOL)
    for key in ("losses/distillation_nll", "losses/regularization"):
        np.testing.assert_allclose(metrics[key].item(), float(jax_metrics[key]), **TOL,
                                   err_msg=key)
    assert float(jax_metrics["losses/regularization"]) != 0.0
    jax_leaves = jax.tree.leaves(jax_grads)
    # The critic takes no part in the loss: no gradient here, zeros in JAX.
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in student.parameters()]
    assert len(grads) == len(jax_leaves)
    for got, want in zip(grads, jax_leaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "contiguous"])
def test_update_phase_matches_jax_distillation_step(jax_setup, shuffle):
    """One whole update phase, batch-major on both sides ("auto" for a
    static student): JAX's distillation_step against distillation_update
    on JAX's rollout, with JAX's selectors pinned (shuffled) or the same
    contiguous blocks, then the student's Normalizer fold. rtol 1e-4 /
    atol 2e-6 on params: 4 adam steps of lr 1e-3, whose normalized
    updates amplify the float32 rounding of near-zero gradients."""
    env, teacher, config, state, rollout_data, selectors = jax_setup
    config = dataclasses.replace(config, shuffle_minibatches=shuffle)
    step = functools.partial(jax_distillation_step, env, teacher, config=config,
                             optimizer=jax_make_optimizer(config.learning_rate))
    new_state, jax_metrics = jax.jit(step)(state)
    _, student = port_pair(jax_teacher=teacher, jax_student=state.student)
    port_config = DistillationConfig(**CFG, shuffle_minibatches=shuffle)
    optimizer = make_optimizer(port_config.learning_rate)
    opt_state = optimizer.init(student.parameters())
    port_rollout = port_distillation_transition(rollout_data)
    loss_metrics = distillation_update(
        student, opt_state, student.initialize_state(N_ENVS), port_rollout, port_config,
        optimizer, selectors=torch.tensor(selectors, dtype=torch.long) if shuffle else None,
    )
    student.update_statistics(port_rollout.student_rollout_extras)
    assert opt_state.param_groups[0]["update_count"] == 4
    np.testing.assert_allclose(loss_metrics["losses/distillation_nll"].mean().item(),
                               float(jax_metrics["losses/distillation_nll/mean"]), rtol=1e-4)
    new_params, new_rest = partition_params(new_state.student)
    for p_jax, p in zip(jax.tree.leaves(new_params), student.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_jax), rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(student[0].mean.numpy(), np.asarray(new_rest.layers[0].mean),
                               **TOL)


def _move_to_center():
    env = EpisodeWrapper(MoveToCenterEnv(), 50)
    teacher = make_mlp_actor_critic(2, 2, [16, 16], [16], 0, normalize_obs=False,
                                    entropy_weight=0.0, initializer_scale=3.0).eval()
    student = make_mlp_actor_critic(2, 2, [16, 16], [16], 99, normalize_obs=False,
                                    entropy_weight=0.0)
    return env, teacher, student


def test_teacher_is_unchanged_while_the_student_learns():
    """distillation_step on the CPU: the student's parameters move and its
    NLL falls over 12 steps (lr 1e-3) below 0.9 of the first (it read
    0.81 of it); the teacher's
    parameters stay the same bits; the step count and the carried env
    states advance; the caller's student is not trained in place."""
    env, teacher, student = _move_to_center()
    config = DistillationConfig(n_envs=16, rollout_length=8, n_epochs=2, n_minibatches=2,
                                learning_rate=1e-3)
    optimizer = make_optimizer(config.learning_rate)
    state = new_distillation_state(env, teacher, student, config.n_envs, seed=0,
                                   optimizer=optimizer, device="cpu")
    teacher_before = [p.detach().clone() for p in teacher.parameters()]
    student_before = [p.detach().clone() for p in student.parameters()]
    nll = []
    for _ in range(12):
        state, metrics = distillation_step(env, teacher, state, config, optimizer)
        nll.append(metrics["losses/distillation_nll/mean"].item())
    assert state.steps_taken == 12 * config.n_envs * config.rollout_length
    assert all(torch.equal(a, p) for a, p in zip(teacher_before, teacher.parameters()))
    assert all(torch.equal(a, p) for a, p in zip(student_before, student.parameters()))
    assert not all(torch.equal(a, p) for a, p in zip(student_before, state.student.parameters()))
    assert np.isfinite(nll).all() and nll[-1] < 0.9 * nll[0], nll


def test_dual_rollout_in_the_port():
    """distillation_unroll_env: the student's actions drive the env, the
    teacher's stored raw action is its mean (eval mode), every leaf is
    stacked time-major, done envs reset."""
    env, teacher, student = _move_to_center()
    g = torch.Generator().manual_seed(1)
    env_state = env.reset(4, g)
    obs0 = env_state.obs
    with torch.no_grad():
        _, _, final_env, rollout_data = distillation_unroll_env(
            env, env_state, teacher, student, student.initialize_state(4),
            teacher.initialize_state(4), 60, g)
        mean = teacher(teacher.initialize_state(4), obs0).output.actions
    assert rollout_data.done.shape == (60, 4) and rollout_data.done.any()
    raw = rollout_data.teacher_rollout_extras["action"][-1]["raw_action"]
    torch.testing.assert_close(torch.tanh(raw[0]), mean, rtol=0, atol=0)
    torch.testing.assert_close(rollout_data.student_output.actions[0],
                               torch.tanh(rollout_data.student_rollout_extras["action"][-1]
                                          ["raw_action"][0]), rtol=0, atol=0)
    assert not torch.equal(rollout_data.student_output.actions[0], mean)
    assert final_env.done.shape == (4,)


def test_train_distillation_full_loop():
    """train_distillation on the CPU to its end, with eval every 64 steps
    and a log per iteration, as JAX's test_full_loop."""
    env, teacher, student = _move_to_center()
    cfg = DistillationTrainConfig(
        distillation=DistillationConfig(n_envs=8, rollout_length=4, total_steps=96,
                                        n_epochs=1, n_minibatches=1),
        eval=EvalConfig(n_envs=4, max_episode_length=10, every_steps=64),
        video=VideoConfig(enabled=False),
    )
    logs = []
    res = train_distillation(env, teacher, student, cfg, log_fn=lambda m, s: logs.append(s),
                             device="cpu")
    assert res.total_steps >= 96 and res.total_iterations == 3
    assert len(res.eval_history) >= 2
    assert logs == [0, 32, 64, 96]
    assert np.isfinite(res.final_metrics["losses/distillation_nll/mean"].item())
    assert default_distillation_config() == DistillationTrainConfig()
    assert teacher.training is False  # the caller's teacher is left as it was


def test_video_fn_is_ignored_while_video_is_off():
    """As in JAX: a ``video_fn`` with ``config.video.enabled`` False is
    never called (and no longer refused)."""
    env, teacher, student = _move_to_center()
    videos = []
    cfg = DistillationTrainConfig(
        distillation=DistillationConfig(n_envs=8, rollout_length=4, total_steps=32),
        eval=EvalConfig(enabled=False),
    )
    res = train_distillation(env, teacher, student, cfg, video_fn=videos.append, device="cpu")
    assert res.total_steps == 32 and videos == []
