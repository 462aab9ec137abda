"""PPO: training state, one train step, the loss, the host loop.

Port of ``nnx_ppo_tpu/algorithms/ppo.py``: ``make_optimizer`` (:102),
``new_training_state`` (:132), ``ppo_step`` (:347-468),
``ppo_multi_step`` (:476-509), ``ppo_loss`` (:512-704) and ``train_ppo``
(:707). PyTorch runs eagerly, so the jitted scans become Python loops
and ``ppo_step`` updates the network and optimizer in place.

Kept from the JAX package:

* the deferred commit: every minibatch loss replays from the
  **pre-rollout** carries, and the running statistics (the Normalizer's
  Welford fold) are folded in only after all E·M updates (:455-467);
* the time-major fused replay: the network is replay-time-static, so
  the loss replays each minibatch as one forward over its ``[T, b]``
  leading dims;
* GAE (``ops/gae.py::gae_per_key``) under no gradient, once per
  minibatch for all reward keys: one CUDA kernel launch for CUDA
  tensors, the plain version per key on the CPU.
  Observations, rewards and value estimates may be dicts (one value
  head per reward key); ``combine_advantages`` sums the per-key
  advantages for the actor.

The optimizer is adam (or adamw) as optax computes it, with PyTorch's
plain per-tensor implementation (``foreach=False``, not fused).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time
from typing import Any, Callable, Optional, Union

import torch

from nnx_ppo_tpu_torch.algorithms import rollout
from nnx_ppo_tpu_torch.algorithms.config import PPOConfig, TrainConfig, TrainResult
from nnx_ppo_tpu_torch.algorithms.metrics import compute_metrics, log_weight_stats
from nnx_ppo_tpu_torch.algorithms.types import LoggingLevel, TrainingState, Transition
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_map, tree_stack
from nnx_ppo_tpu_torch.networks.types import StatefulModule
from nnx_ppo_tpu_torch.ops.gae import gae_per_key
from nnx_ppo_tpu_torch.parallel.permutation import minibatch_plan

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The update rule of :func:`make_optimizer` (the optax chain of the
    JAX package): optional global-norm gradient clipping, then adam, or
    adamw when ``weight_decay`` is set. ``init`` builds the optimizer
    state, a ``torch.optim.Optimizer``; ``step`` applies one update from
    the parameters' ``.grad``."""

    learning_rate: Union[float, Schedule]
    gradient_clipping: Optional[float] = None
    weight_decay: Union[None, bool, float] = None

    def _lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(count))
        return float(self.learning_rate)

    def init(self, params) -> torch.optim.Optimizer:
        # optax adam defaults: b1=0.9, b2=0.999, eps=1e-8, eps_root=0.
        kwargs = dict(lr=self._lr(0), betas=(0.9, 0.999), eps=1e-8, foreach=False)
        if self.weight_decay is None:
            opt = torch.optim.Adam(params, **kwargs)
        else:
            # optax.adamw's default weight decay is 1e-4.
            wd = 1e-4 if self.weight_decay is True else float(self.weight_decay)
            opt = torch.optim.AdamW(params, weight_decay=wd, **kwargs)
        opt.param_groups[0]["update_count"] = 0
        return opt

    def step(self, opt_state: torch.optim.Optimizer) -> None:
        group = opt_state.param_groups[0]
        params = [p for p in group["params"] if p.grad is not None]
        if self.gradient_clipping is not None and params:
            # optax.clip_by_global_norm: g / |g| * max_norm where |g| >= max_norm.
            norm = global_norm([p.grad for p in params])
            for p in params:
                p.grad.copy_(
                    torch.where(
                        norm < self.gradient_clipping,
                        p.grad,
                        p.grad / norm * self.gradient_clipping,
                    )
                )
        group["lr"] = self._lr(group["update_count"])
        opt_state.step()
        group["update_count"] += 1


def global_norm(tensors: list) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all tensors together."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def make_optimizer(
    learning_rate: Union[float, Schedule],
    gradient_clipping: Optional[float] = None,
    weight_decay: Union[None, bool, float] = None,
) -> Optimizer:
    """Optional global-norm clipping + adam (adamw when weight_decay)."""
    return Optimizer(learning_rate, gradient_clipping, weight_decay)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: linear from ``init_value`` to
    ``end_value`` over ``transition_steps`` updates, then constant."""

    def schedule(count: int) -> float:
        frac = min(max(count, 0), transition_steps) / transition_steps
        return init_value + (end_value - init_value) * frac

    return schedule


def new_training_state(
    env: Any,
    networks: StatefulModule,
    n_envs: int,
    seed: int,
    learning_rate: float = 1e-4,
    gradient_clipping: Optional[float] = None,
    weight_decay: Union[None, bool, float] = None,
    optimizer: Optional[Optimizer] = None,
    device: Union[str, torch.device] = "cuda",
) -> TrainingState:
    """Fresh TrainingState on ``device``: a copy of ``networks`` (the
    caller's module is never trained in place), ``n_envs`` reset envs,
    per-env network carries and the optimizer state. Every draw of the
    run comes from one device generator seeded with ``seed``.

    Pass ``optimizer`` when not using the default adam; the same one
    must then be given to ``ppo_step``."""
    device = resolve_device(device)
    networks = copy.deepcopy(networks).to(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    env_states = env.reset(n_envs, generator)
    network_states = networks.initialize_state(n_envs)
    if optimizer is None:
        optimizer = make_optimizer(learning_rate, gradient_clipping, weight_decay)
    return TrainingState(
        networks=networks,
        network_states=network_states,
        env_states=env_states,
        opt_state=optimizer.init(networks.parameters()),
        generator=generator,
        steps_taken=0,
    )


@dataclasses.dataclass
class ReplayMinibatch:
    """The rollout slices the PPO loss reads, time-major ``[T, B, ...]``
    (``ppo.py:176``); ``last_next_obs`` is ``next_obs[-1]``, for the
    T+1 value bootstrap."""

    obs: Any
    old_loglikelihoods: Any
    rewards: Any
    done: torch.Tensor
    truncated: torch.Tensor
    rollout_extras: Any
    last_next_obs: Any

    @classmethod
    def from_rollout(cls, rollout_data: Transition) -> "ReplayMinibatch":
        return cls(
            obs=rollout_data.obs,
            old_loglikelihoods=rollout_data.network_output.loglikelihoods,
            rewards=rollout_data.rewards,
            done=rollout_data.done,
            truncated=rollout_data.truncated,
            rollout_extras=rollout_data.rollout_extras,
            last_next_obs=tree_map(lambda x: x[-1], rollout_data.next_obs),
        )

    def gather(self, sel: torch.Tensor, take_seq, take_batch) -> "ReplayMinibatch":
        """One minibatch (extractors from ``minibatch_plan``)."""
        seq = functools.partial(tree_map, lambda x: take_seq(x, sel))
        return ReplayMinibatch(
            obs=seq(self.obs),
            old_loglikelihoods=seq(self.old_loglikelihoods),
            rewards=seq(self.rewards),
            done=take_seq(self.done, sel),
            truncated=take_seq(self.truncated, sel),
            rollout_extras=seq(self.rollout_extras),
            last_next_obs=tree_map(lambda x: take_batch(x, sel), self.last_next_obs),
        )


def _check_supported(config: PPOConfig) -> None:
    unported = {
        "fused_replay": (config.fused_replay, True),
        "replay_store_dtype": (config.replay_store_dtype, "float32"),
    }
    for name, (value, ported) in unported.items():
        if value != ported:
            raise NotImplementedError(f"PPOConfig.{name}={value!r} is not ported yet")
    if config.rollout_layout not in ("auto", "time_major"):
        raise NotImplementedError(
            f"PPOConfig.rollout_layout={config.rollout_layout!r} is not ported yet"
        )


def ppo_update(
    networks: StatefulModule,
    opt_state: torch.optim.Optimizer,
    network_states: Any,
    rollout_data: Transition,
    config: PPOConfig,
    optimizer: Optimizer,
    *,
    generator: Optional[torch.Generator] = None,
    selectors: Optional[torch.Tensor] = None,
) -> dict[str, Any]:
    """The update phase of :func:`ppo_step`: E·M minibatch gradient
    updates of ``networks`` (in place) on one rollout, replayed from the
    pre-rollout ``network_states``. Minibatches come from ``generator``
    unless ``selectors`` pins them (or ``config.shuffle_minibatches`` is
    off: then they are fixed contiguous env blocks). Returns the loss
    metrics stacked over the updates (leading dim E·M)."""
    view = ReplayMinibatch.from_rollout(rollout_data)
    selectors, take_seq, take_batch = minibatch_plan(
        config.n_envs,
        config.n_epochs,
        config.n_minibatches,
        shuffle=config.shuffle_minibatches,
        generator=generator,
        selectors=selectors,
    )
    per_update = []
    for sel in selectors:
        minibatch = view.gather(sel, take_seq, take_batch)
        net_state_subset = tree_map(lambda x: take_batch(x, sel), network_states)
        opt_state.zero_grad(set_to_none=True)
        loss, loss_metrics = ppo_loss(
            networks,
            net_state_subset,
            minibatch,
            clip_range=config.clip_range,
            normalize_advantages=config.normalize_advantages,
            combine_advantages=config.combine_advantages,
            discounting_factor=config.discounting_factor,
            gae_lambda=config.gae_lambda,
            critic_loss_weight=config.critic_loss_weight,
            logging_level=config.logging_level,
        )
        loss.backward()
        if LoggingLevel.GRAD_NORM in config.logging_level:
            grads = [p.grad for p in networks.parameters() if p.grad is not None]
            loss_metrics["grad_norm"] = global_norm(grads)
        optimizer.step(opt_state)
        per_update.append(tree_map(torch.Tensor.detach, loss_metrics))
    return tree_stack(per_update)


def ppo_step(
    env: Any,
    training_state: TrainingState,
    config: PPOConfig,
    optimizer: Optimizer,
) -> tuple[TrainingState, dict[str, Any]]:
    """One PPO iteration: rollout -> E·M shuffled minibatch updates ->
    metrics -> ``update_statistics`` -> commit the next env/net carries.

    ``training_state.networks`` and ``.opt_state`` are updated in place;
    the returned state holds the advanced carries and step count."""
    _check_supported(config)
    ts = training_state
    if ts.env_states.done.shape[0] != config.n_envs:
        raise ValueError(
            f"training state holds {ts.env_states.done.shape[0]} envs, "
            f"config.n_envs is {config.n_envs}"
        )
    with torch.no_grad():
        next_net_state, next_env_state, rollout_data = rollout.unroll_env(
            env,
            ts.env_states,
            ts.networks,
            ts.network_states,
            config.rollout_length,
            ts.generator,
        )
    loss_metrics = ppo_update(
        ts.networks,
        ts.opt_state,
        ts.network_states,
        rollout_data,
        config,
        optimizer,
        generator=ts.generator,
    )
    total_steps = ts.steps_taken + config.rollout_length * config.n_envs
    metrics = compute_metrics(
        loss_metrics, rollout_data, config.logging_level, config.logging_percentiles
    )
    metrics["total_steps"] = total_steps
    if LoggingLevel.WEIGHTS in config.logging_level:
        log_weight_stats(metrics, ts.networks, config.logging_percentiles)

    # Fold rollout statistics only now, after the updates.
    ts.networks.update_statistics(rollout_data.rollout_extras)
    # Commit the env/net advance only now: the minibatches above replayed
    # from the pre-rollout carries.
    return (
        ts.replace(
            network_states=next_net_state,
            env_states=next_env_state,
            steps_taken=total_steps,
        ),
        metrics,
    )


def ppo_multi_step(
    env: Any,
    training_state: TrainingState,
    config: PPOConfig,
    optimizer: Optimizer,
    n_steps: int,
    return_history: bool = False,
) -> tuple[TrainingState, dict[str, Any]]:
    """``n_steps`` PPO iterations. ``return_history=True`` returns every
    iteration's metrics stacked (leading dim ``n_steps``); otherwise the
    last iteration's."""
    history = []
    for _ in range(n_steps):
        training_state, metrics = ppo_step(env, training_state, config, optimizer)
        history.append(metrics)
    if return_history:
        return training_state, {
            k: torch.stack([torch.as_tensor(m[k]) for m in history]) for k in history[-1]
        }
    return training_state, history[-1]


def ppo_loss(
    networks: StatefulModule,
    network_state: Any,
    rollout_data: Union[ReplayMinibatch, Transition],
    clip_range: float,
    normalize_advantages: bool,
    combine_advantages: bool,
    discounting_factor: float,
    gae_lambda: float,
    critic_loss_weight: float,
    logging_level: LoggingLevel,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Clipped-surrogate PPO loss with replay: re-run the network over
    the stored ``[T, B]`` sequence with its ``rollout_extras``; bootstrap
    the T+1 value with no extras and no generator; per-reward-key GAE;
    optional team-summed advantages; advantage normalization with the
    population std; 0.5·MSE critic; module regularization losses.

    Returns ``(total_loss, loss_metrics)``; gradients come from
    ``total_loss.backward()``."""
    if isinstance(rollout_data, Transition):
        rollout_data = ReplayMinibatch.from_rollout(rollout_data)
    view = rollout_data

    network_output, reg_seq, final_net_state = networks.replay_sequence(
        network_state, view.obs, view.done, view.rollout_extras
    )
    with torch.no_grad():
        # Only the value is read, and GAE carries no gradient.
        last_values = networks(final_net_state, view.last_next_obs).output.value_estimates

    values = network_output.value_estimates
    # Every reward key in one call (one kernel launch on the card); done
    # and truncated are one tensor shared by the keys, or one per key.
    advantages = gae_per_key(
        view.rewards, values, last_values, view.done, view.truncated,
        lambda_=gae_lambda, gamma=discounting_factor,
    )
    target_values = tree_map(lambda v, a: v.detach() + a, values, advantages)

    if combine_advantages:
        summed_advantage = functools.reduce(torch.add, tree_leaves(advantages))
        if torch.is_tensor(network_output.loglikelihoods):
            advantages = summed_advantage
        else:
            advantages = tree_map(lambda _: summed_advantage, network_output.loglikelihoods)

    if normalize_advantages:
        # Population std, as jnp.std (torch's default is unbiased).
        advantages = tree_map(
            lambda a: (a - a.mean()) / (a.std(correction=0) + 1e-8), advantages
        )

    def clipped_loss(new_ll, old_ll, adv):
        # Saturate the log-ratio before exp, as the JAX package does (:653).
        ratios = torch.exp(torch.clamp(new_ll - old_ll, -30.0, 30.0))
        cand1 = ratios * adv
        cand2 = torch.clamp(ratios, 1 - clip_range, 1 + clip_range) * adv
        return -torch.mean(torch.minimum(cand1, cand2))

    actor_losses = tree_map(
        clipped_loss, network_output.loglikelihoods, view.old_loglikelihoods, advantages
    )
    critic_losses = tree_map(
        lambda v, t: 0.5 * torch.mean((v - t) ** 2), values, target_values
    )
    regularization_loss = torch.as_tensor(reg_seq).mean()

    actor_loss = functools.reduce(torch.add, tree_leaves(actor_losses))
    critic_loss = functools.reduce(torch.add, tree_leaves(critic_losses))

    loss_metrics: dict[str, Any] = {}
    if LoggingLevel.LOSSES in logging_level:
        loss_metrics["losses/actor"] = actor_losses
        loss_metrics["losses/critic"] = critic_losses
        loss_metrics["losses/regularization"] = regularization_loss
    if LoggingLevel.ACTOR_EXTRA in logging_level:
        loss_metrics["losses/clipping_fraction"] = tree_map(
            lambda new_ll, old_ll: (
                torch.abs(torch.exp(new_ll - old_ll) - 1.0) > clip_range
            ).float().mean(),
            network_output.loglikelihoods,
            view.old_loglikelihoods,
        )
    if LoggingLevel.CRITIC_EXTRA in logging_level:
        loss_metrics["losses/advantages"] = advantages
        loss_metrics["losses/critic_R^2"] = tree_map(
            lambda l, tv: 1.0 - 2 * l / (tv.var(correction=0) + 1e-8),
            critic_losses,
            target_values,
        )
    total_loss = actor_loss + critic_loss_weight * critic_loss + regularization_loss
    return total_loss, loss_metrics


def _should_run(steps: int, last_step: int, every_steps: int) -> bool:
    if every_steps <= 0:
        return False
    return (steps // every_steps) > (last_step // every_steps)


def _to_host(v: Any) -> Any:
    return v.item() if torch.is_tensor(v) and v.ndim == 0 else v


def train_ppo(
    env: Any,
    networks: StatefulModule,
    config: Optional[TrainConfig] = None,
    *,
    total_steps: Optional[int] = None,
    seed: Optional[int] = None,
    log_fn: Optional[Callable[[dict[str, Any], int], None]] = None,
    video_fn: Optional[Callable] = None,
    checkpoint_fn: Optional[Callable] = None,
    eval_env: Any = None,
    initial_state: Optional[TrainingState] = None,
    optimizer: Optional[Optimizer] = None,
    device: Union[str, torch.device] = "cuda",
) -> TrainResult:
    """Train a PPO agent, with evaluation every ``config.eval.every_steps``.

    ``networks`` is copied, never trained in place. Pass
    ``res.training_state`` back as ``initial_state`` to resume.
    Checkpointing (``checkpoint_fn``) and video (``config.video.enabled``
    or ``video_fn``) are not ported yet and raise ``NotImplementedError``.
    """
    if config is None:
        config = TrainConfig()
    if total_steps is not None:
        config = dataclasses.replace(
            config, ppo=dataclasses.replace(config.ppo, total_steps=total_steps)
        )
    if seed is not None:
        config = dataclasses.replace(config, seed=seed)
    if checkpoint_fn is not None:
        raise NotImplementedError("checkpointing is not ported yet")
    if config.video.enabled or video_fn is not None:
        raise NotImplementedError("video recording is not ported yet")
    _check_supported(config.ppo)
    if eval_env is None:
        eval_env = env

    ppo = config.ppo
    if optimizer is None:
        learning_rate: Union[float, Schedule] = ppo.learning_rate
        if ppo.anneal_lr:
            steps_per_iter = ppo.n_envs * ppo.rollout_length
            n_iters = -(-ppo.total_steps // steps_per_iter)
            n_updates = n_iters * ppo.n_epochs * ppo.n_minibatches
            learning_rate = linear_schedule(ppo.learning_rate, 0.0, max(n_updates, 1))
        optimizer = make_optimizer(learning_rate, ppo.gradient_clipping, ppo.weight_decay)

    if initial_state is None:
        training_state = new_training_state(
            env, networks, ppo.n_envs, config.seed, optimizer=optimizer, device=device
        )
    else:
        training_state = initial_state
    run_device = training_state.generator.device
    measure_throughput = LoggingLevel.THROUGHPUT in ppo.logging_level

    def sync() -> None:
        if run_device.type == "cuda":
            torch.cuda.synchronize(run_device)

    def run_eval(net: StatefulModule) -> dict[str, Any]:
        generator = torch.Generator(device=run_device)
        generator.manual_seed(config.seed)
        t0 = time.perf_counter()
        net.eval()
        try:
            eval_metrics = rollout.eval_rollout(
                eval_env,
                net,
                config.eval.n_envs,
                config.eval.max_episode_length,
                generator,
                config.eval.logging_percentiles,
            )
        finally:
            net.train()
        if measure_throughput:
            sync()
            eval_metrics["throughput/eval_sps"] = (
                config.eval.n_envs * config.eval.max_episode_length
                / (time.perf_counter() - t0)
            )
        return {k: _to_host(v) for k, v in eval_metrics.items()}

    eval_history: list[dict[str, Any]] = []
    metrics: dict[str, Any] = {}
    n_iterations = 0
    steps = training_state.steps_taken
    last_eval_step = -config.eval.every_steps
    if config.eval.enabled:
        metrics.update(run_eval(training_state.networks))
        eval_history.append({"step": steps, **metrics})
        last_eval_step = steps
    if log_fn is not None and metrics:
        log_fn(metrics, steps)

    spc = ppo.steps_per_call
    steps_per_inner = ppo.n_envs * ppo.rollout_length
    while steps < ppo.total_steps:
        t0 = time.perf_counter()
        prev_steps = steps
        training_state, metrics = ppo_multi_step(
            env, training_state, ppo, optimizer, spc, return_history=log_fn is not None
        )
        n_iterations += 1
        steps = training_state.steps_taken
        if measure_throughput:
            sync()
            elapsed = time.perf_counter() - t0
        if log_fn is not None:
            rows = [{k: v[i] for k, v in metrics.items()} for i in range(spc)]
            for i, row in enumerate(rows[:-1]):
                log_fn(row, prev_steps + (i + 1) * steps_per_inner)
            metrics = rows[-1]
        if measure_throughput:
            metrics["throughput/train_sps"] = spc * steps_per_inner / elapsed
        if config.eval.enabled and _should_run(steps, last_eval_step, config.eval.every_steps):
            eval_metrics = run_eval(training_state.networks)
            metrics.update(eval_metrics)
            eval_history.append({"step": steps, **eval_metrics})
            last_eval_step = steps
        if log_fn is not None:
            log_fn(metrics, steps)

    return TrainResult(
        training_state=training_state,
        final_metrics=metrics,
        eval_history=eval_history,
        total_steps=training_state.steps_taken,
        total_iterations=n_iterations,
    )
