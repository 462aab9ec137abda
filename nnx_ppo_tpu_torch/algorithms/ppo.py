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
* the replay layouts of ``PPOConfig.rollout_layout``
  (:func:`resolve_batch_major`, ``ppo.py:320-343``): batch-major (the
  view transposed once per iteration to ``[B, T, ...]``, minibatches
  gathered as whole env rows, one forward over the ``[b, T]`` leading
  dims, :func:`~nnx_ppo_tpu_torch.networks.types.replay_sequence_nd`),
  which ``"auto"`` picks for a fully replay-time-static network under
  ``fused_replay``; else time-major, fused (``networks.replay_sequence``,
  layer-wise over time, so static layers run one forward over their
  ``[T, b]`` leading dims and recurrent ones scan only their own core)
  or the whole-net step scan (``fused_replay=False``,
  :func:`~nnx_ppo_tpu_torch.networks.types.scan_replay`: forward,
  ``reset_state``, ``tree_where(done, ...)``, ``ppo.py:573-585``);
* ``PPOConfig.replay_store_dtype`` (:func:`resolve_store_dtype`): the
  view stores the float observation leaves in bf16, fused into the
  batch-major transpose's one copy; everything else stays exact;
* GAE (``ops/gae.py::gae_per_key``) under no gradient, once per
  minibatch for all reward keys, in the minibatch's layout: one CUDA
  kernel launch for CUDA tensors (batch-major keys read in place), the
  plain version per key on the CPU.
  Observations, rewards and value estimates may be dicts (one value
  head per reward key); ``combine_advantages`` sums the per-key
  advantages for the actor.

The optimizer is adam (or adamw) as optax computes it, with PyTorch's
plain per-tensor implementation (``foreach=False``, not fused).

Data parallelism (``mesh=``, ``parallel/mesh.py``): one process per
device, each holding ``n_envs / world_size`` envs. Every rank draws the
same shard-local minibatch plan from the state's generator (replicated),
rolls out its envs from a generator of its own
(``parallel.mesh.rank_generator``), averages each minibatch's gradients
over the ranks right after the backward, normalizes advantages with the
global minibatch statistics, and folds the global history into the
Normalizer; metrics and ``steps_taken`` are global. No rollout data
crosses ranks, and the parameters stay the same on every rank to the bit.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from nnx_ppo_tpu_torch.algorithms import rollout
from nnx_ppo_tpu_torch.algorithms.config import PPOConfig, TrainConfig, TrainResult, VideoData
from nnx_ppo_tpu_torch.algorithms.metrics import (
    compute_metrics,
    log_weight_stats,
    rollout_counters,
)
from nnx_ppo_tpu_torch.algorithms.types import LoggingLevel, TrainingState, Transition
from nnx_ppo_tpu_torch.core.device import resolve_device
from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_map, tree_stack
from nnx_ppo_tpu_torch.networks.types import StatefulModule, replay_sequence_nd, scan_replay
from nnx_ppo_tpu_torch.ops.gae import gae, gae_per_key  # noqa: F401  (gae: exported here, as in JAX)
from nnx_ppo_tpu_torch.ops.welford import all_mean_var_std
from nnx_ppo_tpu_torch.parallel.mesh import (
    Mesh,
    average_gradients,
    rank_generator,
    shard_training_state,
)
from nnx_ppo_tpu_torch.parallel.permutation import minibatch_plan, shard_local_selectors
from nnx_ppo_tpu_torch.utils.profiling import span

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
        # The state exists from init, as optax's does (count 0, zero
        # moments), so a fresh optimizer has the structure of a stepped
        # one and a checkpoint restores into it by name. Adam takes these
        # as it would its own first-step state: the same bits.
        for p in opt.param_groups[0]["params"]:
            opt.state[p] = {
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }
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


def default_config() -> TrainConfig:
    return TrainConfig()


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


def state_device(device: Union[str, torch.device, None], mesh: Optional[Mesh]) -> torch.device:
    """The device a run's state lives on: ``device`` (default ``"cuda"``)
    without a mesh, the mesh's device with one (``device``, if given,
    must agree)."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device={str(device)!r} differs from the mesh's {mesh.device}")
    return mesh.device


def new_training_state(
    env: Any,
    networks: StatefulModule,
    n_envs: int,
    seed: int,
    learning_rate: float = 1e-4,
    gradient_clipping: Optional[float] = None,
    weight_decay: Union[None, bool, float] = None,
    optimizer: Optional[Optimizer] = None,
    device: Union[str, torch.device, None] = None,
    mesh: Optional[Mesh] = None,
) -> TrainingState:
    """Fresh TrainingState on ``device`` (default ``"cuda"``): a copy of
    ``networks`` (the caller's module is never trained in place),
    ``n_envs`` reset envs, per-env network carries and the optimizer
    state. Every draw of the run comes from one device generator seeded
    with ``seed``.

    With a ``mesh`` (JAX ``ppo.py:140-171``) the state lives on the mesh's
    device, and every rank builds the same ``n_envs`` envs from the seed
    and keeps its own block (:func:`shard_training_state`), so the initial
    env states equal the single-process ones row for row.

    Pass ``optimizer`` when not using the default adam; the same one
    must then be given to ``ppo_step``."""
    device = state_device(device, mesh)
    networks = copy.deepcopy(networks).to(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    env_states = env.reset(n_envs, generator)
    network_states = networks.initialize_state(n_envs)
    if optimizer is None:
        optimizer = make_optimizer(learning_rate, gradient_clipping, weight_decay)
    state = TrainingState(
        networks=networks,
        network_states=network_states,
        env_states=env_states,
        opt_state=optimizer.init(networks.parameters()),
        generator=generator,
        steps_taken=0,
    )
    return state if mesh is None else shard_training_state(state, mesh)


@dataclasses.dataclass
class ReplayMinibatch:
    """The rollout slices the PPO loss reads (``ppo.py:176-300``):
    sequence leaves time-major ``[T, B, ...]``, or batch-major ``[B, T,
    ...]`` where ``batch_major``; ``last_next_obs`` is ``next_obs[-1]``,
    ``[B, ...]``, for the T+1 value bootstrap."""

    obs: Any
    old_loglikelihoods: Any
    rewards: Any
    done: torch.Tensor
    truncated: torch.Tensor
    rollout_extras: Any
    last_next_obs: Any
    batch_major: bool = False

    @classmethod
    def from_rollout(
        cls,
        rollout_data: Transition,
        batch_major: bool = False,
        store_dtype: Optional[torch.dtype] = None,
    ) -> "ReplayMinibatch":
        """The loss's working set of a time-major rollout. ``batch_major``
        transposes every sequence leaf once, into a contiguous copy;
        ``store_dtype`` (:func:`resolve_store_dtype`) stores the float
        observation leaves and ``last_next_obs`` in that dtype, in the
        same copy where there is one (one kernel per leaf, not two).
        Log-likelihoods, rewards, extras and flags stay exact; integer and
        bool observation leaves pass through."""
        seq = functools.partial(store_sequence, batch_major=batch_major)
        return cls(
            obs=seq(rollout_data.obs, store_dtype),
            old_loglikelihoods=seq(rollout_data.network_output.loglikelihoods),
            rewards=seq(rollout_data.rewards),
            done=seq(rollout_data.done),
            truncated=seq(rollout_data.truncated),
            rollout_extras=seq(rollout_data.rollout_extras),
            last_next_obs=store_sequence(
                tree_map(lambda x: x[-1], rollout_data.next_obs), store_dtype, batch_major=False
            ),
            batch_major=batch_major,
        )

    def gather(self, sel: torch.Tensor, take_seq, take_batch) -> "ReplayMinibatch":
        """One minibatch (extractors from ``minibatch_plan``, for this
        view's layout)."""
        seq = functools.partial(tree_map, lambda x: take_seq(x, sel))
        return dataclasses.replace(
            self,
            obs=seq(self.obs),
            old_loglikelihoods=seq(self.old_loglikelihoods),
            rewards=seq(self.rewards),
            done=take_seq(self.done, sel),
            truncated=take_seq(self.truncated, sel),
            rollout_extras=seq(self.rollout_extras),
            last_next_obs=tree_map(lambda x: take_batch(x, sel), self.last_next_obs),
        )


def store_sequence(
    tree: Any, dtype: Optional[torch.dtype] = None, *, batch_major: bool
) -> Any:
    """Every leaf of a time-major ``[T, B, ...]`` tree as a replay view
    stores it: transposed to a contiguous ``[B, T, ...]`` copy where
    ``batch_major``, its float leaves in ``dtype`` where one is given
    (in the same copy: ``x.transpose(0, 1).to(dtype,
    memory_format=torch.contiguous_format)`` is one kernel), integer and
    bool leaves in their own (JAX's ``_downcast_float_leaves``,
    ``ppo.py:294-302``). Leaves left as they are come back uncopied."""

    def store(x: torch.Tensor) -> torch.Tensor:
        to = dtype if dtype is not None and x.is_floating_point() else x.dtype
        if not batch_major:
            return x.to(to)
        x = x.transpose(0, 1)
        # (.to keeps a same-dtype view as it is, whatever memory_format says.)
        return x.contiguous() if to == x.dtype else x.to(to, memory_format=torch.contiguous_format)

    return tree_map(store, tree)


def resolve_store_dtype(config: Any) -> Optional[torch.dtype]:
    """``replay_store_dtype`` of a ``PPOConfig`` or ``DistillationConfig``
    (``ppo.py:305-317``): None for the exact float32 default,
    ``torch.bfloat16`` for ``"bfloat16"``; anything else raises JAX's
    ``ValueError``. The bf16 store is exact only where the network rounds
    its observations to bf16 itself (a bf16-compute stack without obs
    normalization); any other network replays bf16-rounded observations."""
    name = config.replay_store_dtype
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(
        f"unknown replay_store_dtype {name!r}; expected 'float32' or "
        "'bfloat16'"
    )


def resolve_batch_major(config: Any, networks: StatefulModule) -> bool:
    """``rollout_layout`` of a ``PPOConfig`` or ``DistillationConfig``
    against the network (``ppo.py:320-343``): batch-major needs
    ``fused_replay`` and a fully replay-time-static network, and
    ``"auto"`` picks it exactly then; ``"time_major"`` never. JAX's
    ``ValueError`` for ``"batch_major"`` on any other network and for an
    unknown layout."""
    layout = config.rollout_layout
    if layout == "time_major":
        return False
    static = config.fused_replay and networks.replay_time_static
    if layout == "batch_major":
        if not static:
            raise ValueError(
                "rollout_layout='batch_major' requires fused_replay=True "
                "and a fully replay-time-static network (recurrent "
                "modules need the time-major scan replay); use "
                "'time_major' or 'auto'."
            )
        return True
    if layout != "auto":
        raise ValueError(f"unknown rollout_layout {layout!r}")
    return static


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
    mesh: Optional[Mesh] = None,
) -> dict[str, Any]:
    """The update phase of :func:`ppo_step`: E·M minibatch gradient
    updates of ``networks`` (in place) on one rollout, replayed from the
    pre-rollout ``network_states``, in the layout and store dtype the
    config resolves to. Minibatches come from ``generator`` unless
    ``selectors`` pins them (or ``config.shuffle_minibatches`` is off:
    then they are fixed contiguous env blocks). With a ``mesh`` the
    rollout and carries are this rank's block and ``selectors`` (if
    given) the global shard-local plan. Returns the loss metrics
    stacked over the updates (leading dim E·M). Runs inside a profiler
    range named ``ppo_update``."""
    with span("ppo_update"):
        batch_major = resolve_batch_major(config, networks)
        view = ReplayMinibatch.from_rollout(rollout_data, batch_major, resolve_store_dtype(config))

        def loss_fn(net_state_subset, minibatch):
            return ppo_loss(
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
                fused_replay=config.fused_replay,
                mesh=mesh,
            )

        return minibatch_updates(
            networks, opt_state, network_states, view, loss_fn, config, optimizer,
            batch_major=batch_major, generator=generator, selectors=selectors,
            log_grad_norm=LoggingLevel.GRAD_NORM in config.logging_level, mesh=mesh,
        )


def minibatch_updates(
    networks: StatefulModule,
    opt_state: torch.optim.Optimizer,
    network_states: Any,
    view: Any,
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict[str, Any]]],
    config: Any,
    optimizer: Optimizer,
    *,
    batch_major: bool,
    generator: Optional[torch.Generator] = None,
    selectors: Optional[torch.Tensor] = None,
    log_grad_norm: bool = False,
    mesh: Optional[Mesh] = None,
) -> dict[str, Any]:
    """The minibatch loop of :func:`ppo_update` and of
    ``distillation.distillation_update``: for each of the E·M minibatches
    of ``minibatch_plan`` (in ``view``'s layout), gather it from ``view``,
    take the carries of its envs from ``network_states``, and step
    ``optimizer`` on ``loss_fn(carries, minibatch)``'s gradients.
    ``config`` gives ``n_envs``, ``n_epochs``, ``n_minibatches`` and
    ``shuffle_minibatches``. Returns the loss metrics stacked over the
    updates (leading dim E·M), with ``grad_norm`` if ``log_grad_norm``.
    Each minibatch's ``loss_fn``, backward and optimizer step run inside
    profiler ranges named ``update.loss``, ``update.backward`` and
    ``update.optimizer``.

    With a ``mesh`` (``view`` and ``network_states`` this rank's block):
    the plan is JAX's shard-local one over the global ``n_envs``, drawn
    alike on every rank, each rank keeping its block's indices; each
    minibatch's gradients are averaged over the ranks right after the
    backward, so the gradient norm and the optimizer's clipping see the
    global gradient, as optax does under GSPMD (JAX ``ppo.py:404-438``)."""
    if mesh is not None and not config.shuffle_minibatches:
        # Contiguous shard-local blocks: minibatch m is rows [m·k, (m+1)·k)
        # of every rank's block, the one-shard plan over the local envs.
        selectors, take_seq, take_batch = minibatch_plan(
            config.n_envs // mesh.world_size, config.n_epochs, config.n_minibatches,
            shuffle=False, batch_major=batch_major,
        )
    else:
        selectors, take_seq, take_batch = minibatch_plan(
            config.n_envs,
            config.n_epochs,
            config.n_minibatches,
            1 if mesh is None else mesh.world_size,
            shuffle=config.shuffle_minibatches,
            generator=generator,
            selectors=selectors,
            batch_major=batch_major,
        )
        if mesh is not None:
            selectors = shard_local_selectors(selectors, config.n_envs, mesh.world_size,
                                              mesh.rank)
    per_update = []
    for sel in selectors:
        minibatch = view.gather(sel, take_seq, take_batch)
        net_state_subset = tree_map(lambda x: take_batch(x, sel), network_states)
        opt_state.zero_grad(set_to_none=True)
        with span("update.loss"):
            loss, loss_metrics = loss_fn(net_state_subset, minibatch)
        with span("update.backward"):
            loss.backward()
        average_gradients(networks.parameters(), mesh)
        if log_grad_norm:
            grads = [p.grad for p in networks.parameters() if p.grad is not None]
            loss_metrics["grad_norm"] = global_norm(grads)
        with span("update.optimizer"):
            optimizer.step(opt_state)
        per_update.append(tree_map(torch.Tensor.detach, loss_metrics))
    return tree_stack(per_update)


def ppo_step(
    env: Any,
    training_state: TrainingState,
    config: PPOConfig,
    optimizer: Optimizer,
    mesh: Optional[Mesh] = None,
) -> tuple[TrainingState, dict[str, Any]]:
    """One PPO iteration: rollout -> E·M shuffled minibatch updates ->
    metrics -> ``update_statistics`` -> commit the next env/net carries.

    ``training_state.networks`` and ``.opt_state`` are updated in place;
    the returned state holds the advanced carries and step count. With a
    ``mesh`` the state is this rank's (``new_training_state(mesh=)``),
    ``config.n_envs`` the global env count, and metrics and step count
    global. Runs inside a profiler range named ``ppo_step`` (JAX's trace
    shows the jitted function by that name)."""
    with span("ppo_step"):
        ts = training_state
        n_local = config.n_envs // (1 if mesh is None else mesh.world_size)
        if ts.env_states.done.shape[0] != n_local:
            raise ValueError(
                f"training state holds {ts.env_states.done.shape[0]} envs, "
                f"config.n_envs is {config.n_envs}"
                + ("" if mesh is None else f" over {mesh.world_size} ranks")
            )
        with torch.no_grad():
            next_net_state, next_env_state, rollout_data = rollout.unroll_env(
                env,
                ts.env_states,
                ts.networks,
                ts.network_states,
                config.rollout_length,
                rank_generator(ts.generator, mesh),
            )
        loss_metrics = ppo_update(
            ts.networks,
            ts.opt_state,
            ts.network_states,
            rollout_data,
            config,
            optimizer,
            generator=ts.generator,
            mesh=mesh,
        )
        total_steps = ts.steps_taken + config.rollout_length * config.n_envs
        metrics = compute_metrics(
            loss_metrics, rollout_data, config.logging_level, config.logging_percentiles,
            mesh=mesh,
        )
        metrics["total_steps"] = total_steps
        metrics.update(rollout_counters(rollout_data.metrics.get("net", {})))
        if LoggingLevel.WEIGHTS in config.logging_level:
            log_weight_stats(metrics, ts.networks, config.logging_percentiles)

        # Fold rollout statistics only now, after the updates.
        ts.networks.update_statistics(rollout_data.rollout_extras, mesh=mesh)
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
    mesh: Optional[Mesh] = None,
) -> tuple[TrainingState, dict[str, Any]]:
    """``n_steps`` PPO iterations. ``return_history=True`` returns every
    iteration's metrics stacked (leading dim ``n_steps``); otherwise the
    last iteration's."""
    history = []
    for _ in range(n_steps):
        training_state, metrics = ppo_step(env, training_state, config, optimizer, mesh)
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
    fused_replay: bool = True,
    mesh: Optional[Mesh] = None,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Clipped-surrogate PPO loss with replay: re-run the network over
    the stored sequence with its ``rollout_extras`` (a batch-major view:
    one forward over its ``[b, T]`` leading dims, ``replay_sequence_nd``;
    a time-major one: layer-wise ``replay_sequence`` when
    ``fused_replay``, else the whole-net step scan with per-env resets on
    ``done``; the JAX function defaults to the scan, this one to the
    fused form that ``PPOConfig`` selects); bootstrap
    the T+1 value with no extras and no generator; per-reward-key GAE;
    optional team-summed advantages; advantage normalization with the
    population std; 0.5·MSE critic; module regularization losses. With a
    ``mesh`` (the minibatch is this rank's block of the global one) the
    advantage statistics and the critic R² are the global minibatch's,
    from one all-gather (JAX ``ppo.py:643-646``, where GSPMD reduces).

    Returns ``(total_loss, loss_metrics)``; gradients come from
    ``total_loss.backward()``."""
    if isinstance(rollout_data, Transition):
        rollout_data = ReplayMinibatch.from_rollout(rollout_data)
    view = rollout_data

    if view.batch_major:
        network_output, reg_seq, final_net_state = replay_sequence_nd(
            networks, network_state, view.obs, view.done.shape[1], view.rollout_extras,
            done_bt=view.done,
        )
    else:
        replay = (networks.replay_sequence if fused_replay
                  else functools.partial(scan_replay, networks))
        network_output, reg_seq, final_net_state = replay(
            network_state, view.obs, view.done, view.rollout_extras
        )
    with torch.no_grad():
        # Only the value is read, and GAE carries no gradient.
        last_values = networks(final_net_state, view.last_next_obs).output.value_estimates

    values = network_output.value_estimates
    # Every reward key in one call (one kernel launch on the card, which
    # reads a batch-major view's [b, T] keys in place); done and truncated
    # are one tensor shared by the keys, or one per key.
    advantages = gae_per_key(
        view.rewards, values, last_values, view.done, view.truncated,
        lambda_=gae_lambda, gamma=discounting_factor, batch_major=view.batch_major,
    )
    target_values = tree_map(lambda v, a: v.detach() + a, values, advantages)

    if combine_advantages:
        summed_advantage = functools.reduce(torch.add, tree_leaves(advantages))
        if torch.is_tensor(network_output.loglikelihoods):
            advantages = summed_advantage
        else:
            advantages = tree_map(lambda _: summed_advantage, network_output.loglikelihoods)

    r2_pairs = (list(zip(tree_leaves(values), tree_leaves(target_values)))
                if mesh is not None and LoggingLevel.CRITIC_EXTRA in logging_level else [])
    if mesh is not None and (normalize_advantages or r2_pairs):
        # The global minibatch's statistics, every rank's share merged.
        adv_leaves = tree_leaves(advantages) if normalize_advantages else []
        stats = all_mean_var_std(
            adv_leaves + [x for v, t in r2_pairs for x in ((v.detach() - t) ** 2, t)], mesh
        )
        adv_stats = iter(stats[: len(adv_leaves)])
        r2_stats = stats[len(adv_leaves):]
        if normalize_advantages:
            advantages = tree_map(
                lambda a: (a - (s := next(adv_stats))[0]) / (s[2] + 1e-8), advantages
            )
    elif normalize_advantages:
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
        if not view.batch_major and not networks.replay_time_static:
            # Episode ends before a row's last step: resets inside the
            # replayed rows, which a carrying network's replay applies.
            loss_metrics["counters/episode_boundaries"] = view.done[:-1].sum().float()
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
        if mesh is None:
            loss_metrics["losses/critic_R^2"] = tree_map(
                lambda l, tv: 1.0 - 2 * l / (tv.var(correction=0) + 1e-8),
                critic_losses,
                target_values,
            )
        else:
            # Global critic loss (0.5 · mean squared error) over global var.
            r2 = iter(
                1.0 - 2 * (0.5 * sq[0]) / (tv[1] + 1e-8)
                for sq, tv in zip(r2_stats[0::2], r2_stats[1::2])
            )
            loss_metrics["losses/critic_R^2"] = tree_map(lambda _: next(r2), critic_losses)
    total_loss = actor_loss + critic_loss_weight * critic_loss + regularization_loss
    return total_loss, loss_metrics


def _should_run(steps: int, last_step: int, every_steps: int) -> bool:
    if every_steps <= 0:
        return False
    return (steps // every_steps) > (last_step // every_steps)


def _to_host(v: Any) -> Any:
    return v.item() if torch.is_tensor(v) and v.ndim == 0 else v


def record_video(
    eval_env: Any,
    net: StatefulModule,
    config: Any,
    video_fn: Optional[Callable[[VideoData], None]],
    steps: int,
    iteration: int,
    device: torch.device,
) -> bool:
    """One video of both trainers (JAX ``ppo.py:862-886``,
    ``distillation.py:551-570``): the render rollout of ``net`` in eval
    mode on a generator seeded from ``(config.seed, iteration)``,
    ``eval_env.render`` of the trajectory, and ``video_fn`` of the frames.
    Returns False, with nothing done, when there is no ``video_fn`` or
    the env has no ``render``."""
    if video_fn is None or not hasattr(eval_env, "render"):
        return False
    generator = torch.Generator(device=device)
    generator.manual_seed(rollout.render_seed(config.seed, iteration))
    length = config.video.episode_length
    net.eval()
    try:
        stacked, final, episode_reward = rollout.eval_rollout_for_render_scan(
            eval_env, net, length, generator
        )
    finally:
        net.train()
    trajectory = rollout.unstack_trajectory(stacked, final, length)
    frames = eval_env.render(trajectory, **config.video.render_kwargs_dict)
    video_fn(VideoData(frames=np.stack(frames), step=steps,
                       episode_reward=float(episode_reward), episode_length=length))
    return True


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
    device: Union[str, torch.device, None] = None,
    mesh: Optional[Mesh] = None,
) -> TrainResult:
    """Train a PPO agent, with evaluation every ``config.eval.every_steps``
    (JAX ``ppo.py:707-963``).

    ``networks`` is copied, never trained in place. Pass
    ``res.training_state`` back as ``initial_state`` to resume, or a state
    restored by ``checkpointing.load_checkpoint`` to resume exactly.
    ``checkpoint_fn(training_state, step)`` runs at step 0 and then every
    ``config.checkpoint_every_steps``. With ``config.video.enabled``,
    ``video_fn`` gets a :class:`VideoData` at step 0 and then every
    ``config.video.every_steps`` (none without a ``video_fn`` or where the
    eval env has no ``render``); ``video_fn`` alone, with video disabled,
    is ignored, as in JAX.

    ``mesh`` (JAX ``ppo.py:719-810``): data-parallel training, one
    process per device (``parallel/mesh.py``); every rank calls
    ``train_ppo`` alike, holds ``config.ppo.n_envs / world_size`` envs,
    and sees the same parameters, metrics and evaluations. Checkpoint
    under a mesh with ``make_checkpoint_fn(..., mesh=mesh)``.
    """
    if config is None:
        config = TrainConfig()
    if total_steps is not None:
        config = dataclasses.replace(
            config, ppo=dataclasses.replace(config.ppo, total_steps=total_steps)
        )
    if seed is not None:
        config = dataclasses.replace(config, seed=seed)
    # JAX's ValueErrors for an unknown layout or store dtype, before any work.
    resolve_batch_major(config.ppo, networks)
    resolve_store_dtype(config.ppo)
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
            env, networks, ppo.n_envs, config.seed, optimizer=optimizer, device=device,
            mesh=mesh,
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

    def run_video(net: StatefulModule, steps: int, iteration: int) -> dict[str, Any]:
        t0 = time.perf_counter()
        if not record_video(eval_env, net, config, video_fn, steps, iteration, run_device):
            return {}
        if measure_throughput:
            return {"throughput/video_sps": config.video.episode_length
                    / (time.perf_counter() - t0)}
        return {}

    eval_history: list[dict[str, Any]] = []
    metrics: dict[str, Any] = {}
    n_iterations = 0
    steps = training_state.steps_taken
    last_eval_step = -config.eval.every_steps
    last_video_step = -config.video.every_steps
    last_checkpoint_step = -config.checkpoint_every_steps
    if config.eval.enabled:
        metrics.update(run_eval(training_state.networks))
        eval_history.append({"step": steps, **metrics})
        last_eval_step = steps
    if config.video.enabled:
        metrics.update(run_video(training_state.networks, steps, n_iterations))
        last_video_step = steps
    if checkpoint_fn is not None and _should_run(
        steps, last_checkpoint_step, config.checkpoint_every_steps
    ):
        checkpoint_fn(training_state, steps)
        last_checkpoint_step = steps
    if log_fn is not None and metrics:
        log_fn(metrics, steps)

    spc = ppo.steps_per_call
    steps_per_inner = ppo.n_envs * ppo.rollout_length
    while steps < ppo.total_steps:
        t0 = time.perf_counter()
        prev_steps = steps
        training_state, metrics = ppo_multi_step(
            env, training_state, ppo, optimizer, spc, return_history=log_fn is not None,
            mesh=mesh,
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
        if config.video.enabled and _should_run(steps, last_video_step, config.video.every_steps):
            metrics.update(run_video(training_state.networks, steps, n_iterations))
            last_video_step = steps
        if checkpoint_fn is not None and _should_run(
            steps, last_checkpoint_step, config.checkpoint_every_steps
        ):
            checkpoint_fn(training_state, steps)
            last_checkpoint_step = steps
        if log_fn is not None:
            log_fn(metrics, steps)

    return TrainResult(
        training_state=training_state,
        final_metrics=metrics,
        eval_history=eval_history,
        total_steps=training_state.steps_taken,
        total_iterations=n_iterations,
    )
