"""Rollouts. Port of ``nnx_ppo_tpu/algorithms/rollout.py``
(``single_transition`` and ``unroll_env`` :24-87, ``eval_rollout`` :111,
and the video's rollout: ``SlimData``, ``SlimState``, ``_slim``,
``eval_rollout_for_render_scan`` and ``unstack_trajectory``, :166-286).

Environments are batched natively, so one call steps all ``B`` envs. All
draws (sampler noise, draws inside ``env.step``, env resets) come, in a
fixed order, from the one ``generator`` the caller passes. Observations,
rewards and value estimates may be dicts (per-key rewards need per-key
value heads). Call these under ``torch.no_grad()``
when they feed training: rollouts carry no gradient.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from nnx_ppo_tpu_torch.algorithms.types import Transition
from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_map, tree_stack, tree_where
from nnx_ppo_tpu_torch.networks.types import ModuleState, StatefulModule
from nnx_ppo_tpu_torch.utils.profiling import span


def single_transition(
    env: Any,
    networks: StatefulModule,
    carry: tuple[ModuleState, Any],
    generator: torch.Generator,
) -> tuple[tuple[ModuleState, Any], Transition]:
    """One batched env step: net forward -> env.step -> auto-reset both
    the env state and the net carry where ``done``. Everything after the
    net forward runs inside a profiler range named ``rollout.env``, and
    the carry's reset and select inside it in one named
    ``rollout.carry_reset``."""
    network_state, env_state = carry
    out = networks(network_state, env_state.obs, None, generator)
    ppo_output = out.output
    with span("rollout.env"):
        next_env_state = env.step(env_state, ppo_output.actions, generator)
        done = next_env_state.done != 0
        truncated = next_env_state.info.get("truncated")
        if truncated is None:
            truncated = torch.zeros_like(done)
        transition = Transition(
            obs=env_state.obs,
            network_output=ppo_output,
            rewards=next_env_state.reward,
            done=done,
            truncated=truncated.to(torch.bool),
            next_obs=next_env_state.obs,
            metrics={"env": next_env_state.metrics, "net": out.metrics},
            rollout_extras=out.rollout_extras,
        )

        reset_states = env.reset(done.shape[0], generator)
        next_env_state = tree_where(done, reset_states, next_env_state)
        with span("rollout.carry_reset"):
            reset_network_states = networks.reset_state(out.next_state)
            next_network_state = tree_where(done, reset_network_states, out.next_state)
    return (next_network_state, next_env_state), transition


def unroll_env(
    env: Any,
    env_state: Any,
    networks: StatefulModule,
    network_state: ModuleState,
    unroll_length: int,
    generator: torch.Generator,
) -> tuple[ModuleState, Any, Transition]:
    """Run :func:`single_transition` for ``unroll_length`` steps and
    stack the transitions time-major ``[T, B, ...]``. Runs inside a
    profiler range named ``unroll_env``."""
    with span("unroll_env"):
        carry = (network_state, env_state)
        transitions = []
        for _ in range(unroll_length):
            carry, transition = single_transition(env, networks, carry, generator)
            transitions.append(transition)
        rollout = tree_stack(transitions)
    value_shapes = tree_map(lambda v: v.shape, rollout.network_output.value_estimates)
    reward_shapes = tree_map(lambda r: r.shape, rollout.rewards)
    if value_shapes != reward_shapes:
        raise ValueError(
            "value_estimates shapes must match rewards shapes (per reward key): "
            f"{value_shapes} vs {reward_shapes}"
        )
    final_network_state, final_env_state = carry
    return final_network_state, final_env_state, rollout


def _add_reward_metrics(
    out: dict,
    name: str,
    reward: Any,
    percentile_levels: Optional[tuple[int, ...]],
) -> None:
    """Recursively build named metrics from a reward tree."""
    if isinstance(reward, Mapping):
        for k, v in reward.items():
            _add_reward_metrics(out, f"{name}/{k}", v, percentile_levels)
    elif percentile_levels is not None:
        q = torch.tensor(percentile_levels, dtype=reward.dtype, device=reward.device)
        for pl, p in zip(percentile_levels, torch.quantile(reward, q / 100.0)):
            out[f"{name}/p{int(pl)}"] = p
    else:
        out[f"{name}/mean"] = reward.mean()
        out[f"{name}/std"] = reward.std(correction=0)


@torch.no_grad()
def eval_rollout(
    env: Any,
    networks: StatefulModule,
    n_envs: int,
    max_episode_length: int,
    generator: torch.Generator,
    logging_percentiles: Optional[tuple[int, ...]] = None,
) -> dict[str, torch.Tensor]:
    """Fresh-env evaluation: done latches, reward accumulates only while
    alive; emits lifespan and per-reward-key episode reward stats."""
    env_state = env.reset(n_envs, generator)
    network_state = networks.initialize_state(n_envs)
    cuml_reward = tree_map(torch.zeros_like, env_state.reward)
    lifespan = torch.zeros(n_envs, device=env_state.done.device)
    for _ in range(max_episode_length):
        out = networks(network_state, env_state.obs, None, generator)
        next_env_state = env.step(env_state, out.output.actions, generator)
        was_done = env_state.done != 0
        now_done = (next_env_state.done != 0) | was_done
        next_env_state = next_env_state.replace(done=now_done.to(next_env_state.done.dtype))
        cuml_reward = tree_map(
            lambda c, r: c + torch.where(was_done, 0.0, r),
            cuml_reward,
            next_env_state.reward,
        )
        lifespan = lifespan + torch.where(now_done, 0.0, 1.0)
        env_state, network_state = next_env_state, out.next_state

    metrics = dict(lifespan_mean=lifespan.mean(), lifespan_std=lifespan.std(correction=0))
    _add_reward_metrics(metrics, "episode_reward", cuml_reward, logging_percentiles)
    if logging_percentiles is not None:
        q = torch.tensor(logging_percentiles, dtype=lifespan.dtype, device=lifespan.device)
        for pl, p in zip(logging_percentiles, torch.quantile(lifespan, q / 100.0)):
            metrics[f"lifespan/p{int(pl)}"] = p
    return metrics


class SlimData(NamedTuple):
    """Minimal physics-data fields needed for rendering."""

    qpos: Any
    qvel: Any
    time: Any
    mocap_pos: Any
    mocap_quat: Any
    xfrc_applied: Any


class SlimState(NamedTuple):
    """Minimal env state for rendering: the render rollout stacks only
    these over T."""

    data: Any
    done: Any
    info: Any
    metrics: Any


def _slim(env_state: Any) -> SlimState:
    """The render-relevant fields of a batched env state: the slim field
    subset of MuJoCo-style ``data`` (an object with ``qpos``; fields it
    lacks are zeros ``[B]``), the observation where there is no ``data``,
    else ``data`` as it is (the analytic and rigid-body envs' dicts)."""
    data = getattr(env_state, "data", None)
    if data is not None and hasattr(data, "qpos"):
        zeros = torch.zeros(data.qpos.shape[:1], device=data.qpos.device)
        data = SlimData(
            qpos=data.qpos,
            qvel=data.qvel,
            time=getattr(data, "time", zeros),
            mocap_pos=getattr(data, "mocap_pos", zeros),
            mocap_quat=getattr(data, "mocap_quat", zeros),
            xfrc_applied=getattr(data, "xfrc_applied", zeros),
        )
    elif data is None:
        data = env_state.obs
    return SlimState(data=data, done=env_state.done, info=env_state.info,
                     metrics=env_state.metrics)


@torch.no_grad()
def eval_rollout_for_render_scan(
    env: Any,
    networks: StatefulModule,
    max_episode_length: int,
    generator: torch.Generator,
) -> tuple[SlimState, SlimState, torch.Tensor]:
    """One env (``env.reset(1, generator)``) for ``max_episode_length``
    steps, collecting a :class:`SlimState` per step for rendering on the
    host. Call it with the networks in eval mode, as the trainers do. A
    done env and its carry are reset in place, as JAX's ``where`` does;
    the reward adds up until the first ``done``.

    Returns ``(stacked_states [T], final_state, total_reward)`` on the
    host, without the env axis: the per-step states are stacked on the
    device and copied to the host once, a copy per leaf, not one per
    frame. JAX's render key is ``fold_in(key(seed), iteration)``; the
    trainers seed ``generator`` from ``(seed, iteration)``
    (:func:`render_seed`), so the draws differ from JAX's threefry ones."""
    env_state = env.reset(1, generator)
    net_state = networks.initialize_state(1)
    device = env_state.done.device
    total_reward = torch.zeros((), device=device)
    already_done = torch.zeros((), dtype=torch.bool, device=device)
    slims = []
    for _ in range(max_episode_length):
        out = networks(net_state, env_state.obs, None, generator)
        next_env_state = env.step(env_state, out.output.actions, generator)
        reward_sum = sum(tree_leaves(next_env_state.reward))[0]
        total_reward = total_reward + torch.where(already_done, 0.0, reward_sum)
        done = next_env_state.done != 0
        already_done = already_done | done[0]
        reset_env_state = env.reset(1, generator)
        next_env_state = tree_where(done, reset_env_state, next_env_state)
        net_state = tree_where(done, networks.reset_state(out.next_state), out.next_state)
        slims.append(_slim(env_state))
        env_state = next_env_state
    slims.append(_slim(env_state))
    host = tree_map(lambda x: x[:, 0].cpu(), tree_stack(slims))
    stacked = tree_map(lambda x: x[:-1], host)
    final = tree_map(lambda x: x[-1], host)
    return stacked, final, total_reward.cpu()


def unstack_trajectory(stacked_states: Any, final_state: Any, max_episode_length: int) -> list:
    """The stacked render rollout as a per-step list for ``env.render``:
    ``max_episode_length`` states, then the final one."""
    trajectory = [tree_map(lambda x, i=i: x[i], stacked_states) for i in range(max_episode_length)]
    trajectory.append(final_state)
    return trajectory


def render_seed(seed: int, iteration: int) -> int:
    """The video generator's seed for a run's ``seed`` and ``iteration``,
    the port's counterpart of JAX's ``fold_in(key(seed), iteration)``:
    the two integers mixed by numpy's ``SeedSequence``."""
    return int(np.random.SeedSequence([seed, iteration]).generate_state(1, np.uint64)[0] >> 1)
