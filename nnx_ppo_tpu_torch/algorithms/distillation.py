"""Policy distillation (Rusu et al. 2015). Port of
``nnx_ppo_tpu/algorithms/distillation.py``.

1. Roll out the env with the **student**'s actions; the frozen teacher
   runs alongside on the same observations.
2. The teacher runs in eval mode (``module.eval()``, the JAX
   ``deterministic`` flag), so its ``rollout_extras`` hold the teacher's
   action *mean* at every sampler.
3. Train the student to minimise the NLL of the teacher's stored action
   under the student's distribution, by feeding the **teacher's**
   ``rollout_extras`` into the student's loss replay (KL(teacher ||
   student) up to H(teacher)).

As in the JAX package, teacher and student must have isomorphic carry and
``rollout_extras`` trees. The update phase is ``ppo_step``'s: the layout
and store dtype resolved from the config (batch-major for a fully
replay-time-static student under ``fused_replay``), minibatches from
``parallel/permutation.py::minibatch_plan``, the student and its
optimizer updated in place, the student's statistics folded in after the
updates, the carries committed last. Every draw comes from the state's
one ``generator``, through the networks, the env's ``step`` and
``reset`` and ``minibatch_plan`` (whose selectors a test can pin); no
draw is made here. Data parallelism (``mesh=``) is ``ppo.py``'s: each
rank holds its block of the envs and both carries, the plan is
shard-local, the student's gradients are averaged over the ranks and its
statistics and the metrics are global (JAX ``distillation.py:272-325``,
``:385-447``, ``:465-514``).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Callable, Optional, Union

import torch
from torch.profiler import record_function

from nnx_ppo_tpu_torch.algorithms import rollout
from nnx_ppo_tpu_torch.algorithms.config import (
    DistillationConfig,
    DistillationTrainConfig,
    DistillationTrainResult,
)
from nnx_ppo_tpu_torch.algorithms.metrics import _flatten, summarize_metrics
from nnx_ppo_tpu_torch.algorithms.ppo import (
    Optimizer,
    _should_run,
    _to_host,
    make_optimizer,
    minibatch_updates,
    record_video,
    resolve_batch_major,
    resolve_store_dtype,
    state_device,
    store_sequence,
)
from nnx_ppo_tpu_torch.algorithms.types import (
    DistillationState,
    DistillationTransition,
    LoggingLevel,
)
from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_map, tree_stack, tree_where
from nnx_ppo_tpu_torch.networks.types import (
    ModuleState,
    StatefulModule,
    replay_sequence_nd,
    scan_replay,
)
from nnx_ppo_tpu_torch.parallel.mesh import (
    Mesh,
    place_batched,
    rank_generator,
)


def default_distillation_config() -> DistillationTrainConfig:
    return DistillationTrainConfig()


def distillation_single_transition(
    env: Any,
    teacher: StatefulModule,
    student: StatefulModule,
    carry: tuple[ModuleState, ModuleState, Any],
    generator: torch.Generator,
) -> tuple[tuple[ModuleState, ModuleState, Any], DistillationTransition]:
    """One batched step (``distillation.py:76-116``): the student acts,
    the teacher observes; both extras are recorded; the env and both
    carries auto-reset where ``done``."""
    student_state, teacher_state, env_state = carry
    student_out = student(student_state, env_state.obs, None, generator)
    teacher_out = teacher(teacher_state, env_state.obs, None, generator)
    next_env_state = env.step(env_state, student_out.output.actions, generator)
    done = next_env_state.done != 0
    truncated = next_env_state.info.get("truncated")
    if truncated is None:
        truncated = torch.zeros_like(done)
    transition = DistillationTransition(
        obs=env_state.obs,
        student_output=student_out.output,
        rewards=next_env_state.reward,
        done=done,
        truncated=truncated.to(torch.bool),
        next_obs=next_env_state.obs,
        metrics={"env": next_env_state.metrics, "student": student_out.metrics},
        student_rollout_extras=student_out.rollout_extras,
        teacher_rollout_extras=teacher_out.rollout_extras,
    )
    reset_env_states = env.reset(done.shape[0], generator)
    next_env_state = tree_where(done, reset_env_states, next_env_state)
    next_student_state = tree_where(
        done, student.reset_state(student_out.next_state), student_out.next_state
    )
    next_teacher_state = tree_where(
        done, teacher.reset_state(teacher_out.next_state), teacher_out.next_state
    )
    return (next_student_state, next_teacher_state, next_env_state), transition


def distillation_unroll_env(
    env: Any,
    env_state: Any,
    teacher: StatefulModule,
    student: StatefulModule,
    student_state: ModuleState,
    teacher_state: ModuleState,
    unroll_length: int,
    generator: torch.Generator,
) -> tuple[ModuleState, ModuleState, Any, DistillationTransition]:
    """:func:`distillation_single_transition` for ``unroll_length``
    steps, stacked time-major ``[T, B, ...]``. Call it under
    ``torch.no_grad()`` when it feeds training."""
    carry = (student_state, teacher_state, env_state)
    transitions = []
    for _ in range(unroll_length):
        carry, transition = distillation_single_transition(env, teacher, student, carry, generator)
        transitions.append(transition)
    final_student_state, final_teacher_state, final_env_state = carry
    return final_student_state, final_teacher_state, final_env_state, tree_stack(transitions)


@dataclasses.dataclass
class DistillationMinibatch:
    """The rollout slices the distillation loss reads
    (``distillation.py:140-194``): obs, done and the teacher's extras, time-major
    ``[T, B, ...]`` or batch-major ``[B, T, ...]``. ``store_dtype`` stores
    only the float obs leaves in that dtype; the teacher's extras always
    stay exact, so the NLL target is unchanged."""

    obs: Any
    done: torch.Tensor
    teacher_rollout_extras: Any
    batch_major: bool = False

    @classmethod
    def from_rollout(
        cls,
        rollout_data: DistillationTransition,
        batch_major: bool = False,
        store_dtype: Optional[torch.dtype] = None,
    ) -> "DistillationMinibatch":
        seq = functools.partial(store_sequence, batch_major=batch_major)
        return cls(
            obs=seq(rollout_data.obs, store_dtype),
            done=seq(rollout_data.done),
            teacher_rollout_extras=seq(rollout_data.teacher_rollout_extras),
            batch_major=batch_major,
        )

    def gather(self, sel: torch.Tensor, take_seq, take_batch) -> "DistillationMinibatch":
        """One minibatch (extractors from ``minibatch_plan``; this view has
        no per-env leaves, so ``take_batch`` is unused)."""
        del take_batch
        seq = functools.partial(tree_map, lambda x: take_seq(x, sel))
        return dataclasses.replace(
            self,
            obs=seq(self.obs),
            done=take_seq(self.done, sel),
            teacher_rollout_extras=seq(self.teacher_rollout_extras),
        )


def distillation_loss(
    student: StatefulModule,
    student_state: ModuleState,
    rollout_data: Union[DistillationMinibatch, DistillationTransition],
    logging_level: LoggingLevel,
    fused_replay: bool = True,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """NLL of the teacher's stored action under the student's
    distribution (``distillation.py:197-263``): the student replays its
    sequence fed the TEACHER's ``rollout_extras``. A batch-major view
    replays as one forward over its ``[b, T]`` leading dims
    (``replay_sequence_nd``); a time-major one layer-wise over time
    (``fused_replay``) or by the whole-net step scan with per-env resets
    on ``done``. (The JAX function defaults ``fused_replay`` to False;
    this one, as ``ppo_loss``, to the fused form the config selects.)
    The student's regularization is kept, the teacher's ignored.

    Returns ``(total_loss, loss_metrics)``; gradients come from
    ``total_loss.backward()``."""
    if isinstance(rollout_data, DistillationTransition):
        rollout_data = DistillationMinibatch.from_rollout(rollout_data)
    view = rollout_data
    if view.batch_major:
        output_seq, reg_seq, _ = replay_sequence_nd(
            student, student_state, view.obs, view.done.shape[1], view.teacher_rollout_extras,
            done_bt=view.done,
        )
    else:
        replay = (student.replay_sequence if fused_replay
                  else functools.partial(scan_replay, student))
        output_seq, reg_seq, _ = replay(
            student_state, view.obs, view.done, view.teacher_rollout_extras
        )
    per_head_nll = tree_map(lambda ll: -ll.mean(), output_seq.loglikelihoods)
    nll_loss = functools.reduce(torch.add, tree_leaves(per_head_nll))
    regularization_loss = torch.as_tensor(reg_seq).mean()
    total_loss = nll_loss + regularization_loss

    loss_metrics: dict[str, Any] = {}
    if LoggingLevel.LOSSES in logging_level:
        loss_metrics["losses/distillation_nll"] = nll_loss
        loss_metrics["losses/regularization"] = regularization_loss
    return total_loss, loss_metrics


def distillation_update(
    student: StatefulModule,
    opt_state: torch.optim.Optimizer,
    student_states: Any,
    rollout_data: DistillationTransition,
    config: DistillationConfig,
    optimizer: Optimizer,
    *,
    generator: Optional[torch.Generator] = None,
    selectors: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
) -> dict[str, Any]:
    """The update phase of :func:`distillation_step`
    (``distillation.py:303-345``): E·M minibatch gradient updates of
    ``student`` (in place) on one rollout, replayed from the pre-rollout
    ``student_states``, in the layout and store dtype the config
    resolves to. Minibatches come from ``generator`` unless ``selectors``
    pins them (or ``config.shuffle_minibatches`` is off). Returns the
    loss metrics stacked over the updates (leading dim E·M)."""
    batch_major = resolve_batch_major(config, student)
    view = DistillationMinibatch.from_rollout(
        rollout_data, batch_major, resolve_store_dtype(config)
    )
    return minibatch_updates(
        student, opt_state, student_states, view,
        lambda state_subset, minibatch: distillation_loss(
            student, state_subset, minibatch, config.logging_level,
            fused_replay=config.fused_replay,
        ),
        config, optimizer, batch_major=batch_major, generator=generator, selectors=selectors,
        mesh=mesh,
    )


def distillation_step(
    env: Any,
    teacher: StatefulModule,
    distillation_state: DistillationState,
    config: DistillationConfig,
    optimizer: Optimizer,
    mesh: Optional[Mesh] = None,
) -> tuple[DistillationState, dict[str, Any]]:
    """One distillation iteration (``distillation.py:266-375``): dual
    rollout -> E·M minibatch updates -> student statistics fold ->
    commit the next carries. ``distillation_state.student`` and
    ``.opt_state`` are updated in place; the teacher is used as given (in
    eval mode for the distillation target to be its mean). Runs inside a
    profiler range named ``distillation_step``."""
    with record_function("distillation_step"):
        ds = distillation_state
        n_local = config.n_envs // (1 if mesh is None else mesh.world_size)
        if ds.env_states.done.shape[0] != n_local:
            raise ValueError(
                f"distillation state holds {ds.env_states.done.shape[0]} envs, "
                f"config.n_envs is {config.n_envs}"
                + ("" if mesh is None else f" over {mesh.world_size} ranks")
            )
        with torch.no_grad():
            next_student_state, next_teacher_state, next_env_state, rollout_data = (
                distillation_unroll_env(
                    env, ds.env_states, teacher, ds.student, ds.student_states,
                    ds.teacher_states, config.rollout_length,
                    rank_generator(ds.generator, mesh),
                )
            )
        loss_metrics = distillation_update(
            ds.student, ds.opt_state, ds.student_states, rollout_data, config, optimizer,
            generator=ds.generator, mesh=mesh,
        )
        total_steps = ds.steps_taken + config.rollout_length * config.n_envs
        # Fold the student's own rollout extras into its running statistics.
        ds.student.update_statistics(rollout_data.student_rollout_extras, mesh=mesh)

        samples: list[tuple[str, torch.Tensor]] = []
        if LoggingLevel.TRAIN_ROLLOUT_STATS in config.logging_level:
            samples += _flatten("rollout_batch/reward", rollout_data.rewards)
            samples += _flatten("rollout_batch/action", rollout_data.student_output.actions)
            samples.append(("rollout_batch/done_rate", rollout_data.done != 0))
            samples.append(("rollout_batch/truncation_rate", rollout_data.truncated != 0))
        if LoggingLevel.TRAINING_ENV_METRICS in config.logging_level:
            for k, v in rollout_data.metrics.items():
                samples += _flatten(k, v)
        metrics = summarize_metrics(loss_metrics, samples, config.logging_percentiles, mesh)
        metrics["total_steps"] = total_steps
        return (
            ds.replace(
                student_states=next_student_state,
                teacher_states=next_teacher_state,
                env_states=next_env_state,
                steps_taken=total_steps,
            ),
            metrics,
        )


def distillation_multi_step(
    env: Any,
    teacher: StatefulModule,
    distillation_state: DistillationState,
    config: DistillationConfig,
    optimizer: Optimizer,
    n_steps: int,
    mesh: Optional[Mesh] = None,
) -> tuple[DistillationState, dict[str, Any]]:
    """``n_steps`` distillation iterations; returns the last one's
    metrics (``distillation.py:378-400``)."""
    metrics: dict[str, Any] = {}
    for _ in range(n_steps):
        distillation_state, metrics = distillation_step(
            env, teacher, distillation_state, config, optimizer, mesh
        )
    return distillation_state, metrics


def new_distillation_state(
    env: Any,
    teacher: StatefulModule,
    student: StatefulModule,
    n_envs: int,
    seed: int,
    learning_rate: float = 1e-4,
    gradient_clipping: Optional[float] = None,
    weight_decay: Union[None, bool, float] = None,
    optimizer: Optional[Optimizer] = None,
    device: Union[str, torch.device, None] = None,
    mesh: Optional[Mesh] = None,
) -> DistillationState:
    """Fresh DistillationState on ``device`` (default ``"cuda"``;
    ``distillation.py:403-449``): a copy of ``student`` (the caller's
    module is never trained in place), ``n_envs`` reset envs, both per-env
    carries, and the optimizer state over the student's parameters only.
    Every draw of the run comes from one device generator seeded with
    ``seed``. With a ``mesh``, on the mesh's device, every rank builds the
    same ``n_envs`` envs and carries and keeps its own block."""
    device = state_device(device, mesh)
    student = copy.deepcopy(student).to(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    env_states = env.reset(n_envs, generator)
    if optimizer is None:
        optimizer = make_optimizer(learning_rate, gradient_clipping, weight_decay)
    state = DistillationState(
        student=student,
        student_states=student.initialize_state(n_envs),
        teacher_states=tree_map(lambda x: x.to(device), teacher.initialize_state(n_envs)),
        env_states=env_states,
        opt_state=optimizer.init(student.parameters()),
        generator=generator,
        steps_taken=0,
    )
    if mesh is None:
        return state
    return state.replace(
        student_states=place_batched(state.student_states, mesh),
        teacher_states=place_batched(state.teacher_states, mesh),
        env_states=place_batched(state.env_states, mesh),
    )


def train_distillation(
    env: Any,
    teacher: StatefulModule,
    student: StatefulModule,
    config: Optional[DistillationTrainConfig] = None,
    *,
    total_steps: Optional[int] = None,
    seed: Optional[int] = None,
    log_fn: Optional[Callable[[dict[str, Any], int], None]] = None,
    video_fn: Optional[Callable] = None,
    checkpoint_fn: Optional[Callable] = None,
    eval_env: Any = None,
    initial_state: Optional[DistillationState] = None,
    device: Union[str, torch.device, None] = None,
    mesh: Optional[Mesh] = None,
) -> DistillationTrainResult:
    """Train a student by distillation from a frozen teacher
    (``distillation.py:452-629``), with evaluation of the student every
    ``config.eval.every_steps``. The teacher runs from a copy in eval
    mode on the run's device; ``student`` is copied, never trained in
    place. Pass ``res.training_state`` back as ``initial_state`` to
    resume, or a state restored by ``checkpointing.load_checkpoint`` to
    resume exactly. Checkpoints and videos follow ``train_ppo``'s cadence
    (``distillation.py:527-619``), the video of the student in eval mode;
    a ``video_fn`` with video disabled is ignored. ``mesh``: data-parallel
    training as ``train_ppo``'s (checkpoint with
    ``make_checkpoint_fn(..., mesh=mesh)``)."""
    if config is None:
        config = default_distillation_config()
    if total_steps is not None:
        config = dataclasses.replace(
            config,
            distillation=dataclasses.replace(config.distillation, total_steps=total_steps),
        )
    if seed is not None:
        config = dataclasses.replace(config, seed=seed)
    dcfg = config.distillation
    # JAX's ValueErrors for an unknown layout or store dtype, before any work.
    resolve_batch_major(dcfg, student)
    resolve_store_dtype(dcfg)
    if eval_env is None:
        eval_env = env

    optimizer = make_optimizer(dcfg.learning_rate, dcfg.gradient_clipping, dcfg.weight_decay)
    if initial_state is None:
        state = new_distillation_state(
            env, teacher, student, dcfg.n_envs, config.seed, optimizer=optimizer, device=device,
            mesh=mesh,
        )
    else:
        state = initial_state
    run_device = state.generator.device
    # Deterministic teacher: its sampler extras hold the teacher's mean.
    teacher = copy.deepcopy(teacher).to(run_device).eval()

    def run_eval(net: StatefulModule) -> dict[str, Any]:
        generator = torch.Generator(device=run_device)
        generator.manual_seed(config.seed)
        net.eval()
        try:
            eval_metrics = rollout.eval_rollout(
                eval_env, net, config.eval.n_envs, config.eval.max_episode_length, generator,
                config.eval.logging_percentiles,
            )
        finally:
            net.train()
        return {k: _to_host(v) for k, v in eval_metrics.items()}

    eval_history: list[dict[str, Any]] = []
    metrics: dict[str, Any] = {}
    n_iterations = 0
    steps = state.steps_taken
    last_eval_step = -config.eval.every_steps
    last_video_step = -config.video.every_steps
    last_checkpoint_step = -config.checkpoint_every_steps
    if config.eval.enabled:
        metrics.update(run_eval(state.student))
        eval_history.append({"step": steps, **metrics})
        last_eval_step = steps
    if config.video.enabled:
        record_video(eval_env, state.student, config, video_fn, steps, n_iterations, run_device)
        last_video_step = steps
    if checkpoint_fn is not None and _should_run(
        steps, last_checkpoint_step, config.checkpoint_every_steps
    ):
        checkpoint_fn(state, steps)
        last_checkpoint_step = steps
    if log_fn is not None and metrics:
        log_fn(metrics, steps)

    while steps < dcfg.total_steps:
        state, metrics = distillation_step(env, teacher, state, dcfg, optimizer, mesh)
        n_iterations += 1
        steps = state.steps_taken
        if config.eval.enabled and _should_run(steps, last_eval_step, config.eval.every_steps):
            eval_metrics = run_eval(state.student)
            metrics.update(eval_metrics)
            eval_history.append({"step": steps, **eval_metrics})
            last_eval_step = steps
        if config.video.enabled and _should_run(steps, last_video_step, config.video.every_steps):
            record_video(eval_env, state.student, config, video_fn, steps, n_iterations,
                         run_device)
            last_video_step = steps
        if checkpoint_fn is not None and _should_run(
            steps, last_checkpoint_step, config.checkpoint_every_steps
        ):
            checkpoint_fn(state, steps)
            last_checkpoint_step = steps
        if log_fn is not None:
            log_fn(metrics, steps)

    return DistillationTrainResult(
        training_state=state,
        final_metrics=metrics,
        eval_history=eval_history,
        total_steps=state.steps_taken,
        total_iterations=n_iterations,
    )
