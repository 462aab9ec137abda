"""One PPO iteration of the reference, written from the algorithm's
definition (Schulman et al. 2017, with GAE, Schulman et al. 2016), in
plain PyTorch:

1. a rollout of ``T`` steps over ``B`` envs: the policy samples, the
   task steps, and every env that is done is reset (a full batch of
   resets is drawn each step and taken where done);
2. ``E`` epochs of ``M`` minibatches of whole env rows, drawn as one
   permutation of the envs per epoch; each minibatch replays the
   policy and values over its ``[b, T]`` rows from the stored noise,
   bootstraps the last value, computes GAE per reward key, sums the
   keys' advantages for the actor where the configuration says so,
   standardizes them over the minibatch, and takes one Adam step on
   the clipped surrogate plus ``0.5`` mean squared value error plus the
   entropy cost;
3. the observation normalizer (where there is one) folds the rollout's
   observations in, after the updates.

A network is an object with ``rollout(params, stats, obs, gen)``,
``replay(params, stats, obs, extras)``, ``values(params, stats, obs)``
and ``normalized_input(obs)`` (see ``quadruped_rough.py``); a task has
``reset``, ``step``, ``obs`` and ``rewards`` (``legged.py``,
``cartpole.py``). The state that one iteration starts from is a dict
``{"params", "adam_m", "adam_v", "adam_count", "stats", "env",
"generator"}``; the iteration returns the same keys, ``"controls"``,
``"updates"`` and ``"loss"``, the mean over the updates it ran of the
total loss.

A network that carries state (``cartpole_gru.py``) also has
``initial_carry(B, device)`` and ``reset_carry(carry, done)``, and takes
and returns the carry: ``rollout(params, stats, obs, gen, carry) ->
(action, loglik, extras, next_carry)``, ``replay(..., carry, done) ->
(loglik, values, reg, final_carry)``, ``values(..., carry)``. The state
then holds ``"carry"``, the carry at the iteration's start; the rollout
threads it through its ``T`` steps, reset where ``done``, and keeps the
start carry in the record, so that each minibatch replays its rows from
the carry they started with and bootstraps the last value from the
replay's final carry. The iteration returns the carry after the rollout.

Where another implementation's states are given (``follow``), each
control step of the rollout starts from that implementation's env state
and generator, and each update from its parameters and moments: one
step's result is then compared with the other's at a time, so a rounding
that differs once is not carried on and grown by the chaos of the
physics or of Adam. The carry is not taken from the other at each
control step (it is compared at the iteration's end), and an update that
``follow`` leaves out is not run.
"""

from __future__ import annotations

import functools

import torch

from portbench.reference.nets import adam_step, fold_moments


def gae(rewards, values, last_value, done, truncated, lam: float, gamma: float):
    """Advantages ``[b, T]`` of one reward key, backwards in time: the TD
    error with the next value (zero past a done step), zeroed on a
    truncated step, plus ``gamma lambda`` times the next advantage
    (not carried past a done step)."""
    done = done.to(torch.float32)
    truncated = truncated.to(torch.float32)
    next_value = last_value
    next_adv = torch.zeros_like(last_value)
    out = []
    for t in reversed(range(rewards.shape[1])):
        value = values[:, t]
        bootstrap = torch.where(done[:, t] != 0, 0.0, next_value)
        adv = rewards[:, t] + gamma * bootstrap - value
        adv = torch.where(truncated[:, t] != 0, 0.0, adv)
        next_adv = adv + (1.0 - done[:, t]) * gamma * lam * next_adv
        out.append(next_adv)
        next_value = value
    return torch.stack(out[::-1], dim=1)


def rollout(task, net, params, stats, env, T: int, gen, physics=None, follow=None, carry=None,
            fault=None):
    """``T`` steps of every env. Returns the final env state, the record
    the update reads, batch-major ``[B, T, ...]``, and ``"controls"``:
    after each control step, the env state (reset where done) and the
    generator's state. Where ``follow`` gives another implementation's
    ``T`` control steps (``{"env"}``: the state that entered the step;
    ``{"generator"}``: the generator after the step's resets), each step
    after the first starts from its state and generator. With a
    ``carry``, the record also holds it as ``"carry"`` and the carry
    after the last step as ``"final_carry"``."""
    rec = {"obs": [], "extras": [], "loglik": [], "rewards": [], "done": [], "truncated": []}
    observed, controls = [], []
    B = env["done"].shape[0]
    start = carry
    for t in range(T):
        if follow is not None and t > 0:
            env = follow[t]["env"]
            gen.set_state(follow[t - 1]["generator"])
        obs = task.obs(env)
        if start is None:
            action, loglik, extras = net.rollout(params, stats, obs, gen)
        else:
            action, loglik, extras, carry = net.rollout(params, stats, obs, gen, carry)
        nxt = task.step(env, action, gen, physics)
        done = nxt["done"] != 0
        rec["obs"].append(obs)
        observed.append(net.normalized_input(obs))
        rec["extras"].append(extras)
        rec["loglik"].append(loglik)
        rec["rewards"].append(task.rewards(nxt))
        rec["done"].append(done)
        rec["truncated"].append(nxt["truncated"])
        last_next_obs = task.obs(nxt)
        fresh = task.reset(B, gen)
        env = {k: torch.where(done.reshape((B,) + (1,) * (v.ndim - 1)), fresh[k], v)
               for k, v in nxt.items()}
        if start is not None and fault != "carry_reset":
            carry = net.reset_carry(carry, done)
        controls.append({"env": env, "generator": gen.get_state()})

    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([x[k] for x in items]) for k in first}
        if isinstance(first, tuple):
            return tuple(stack([x[i] for x in items]) for i in range(len(first)))
        return torch.stack(items, dim=1)

    out = {k: stack(v) for k, v in rec.items()}
    out["last_next_obs"] = last_next_obs
    # What the normalizer folds in, time-major [T, B, f].
    out["history"] = torch.stack(observed) if observed[0] is not None else None
    out["controls"] = controls
    if start is not None:
        out["carry"], out["final_carry"] = start, carry
    return env, out


def take(tree, rows):
    if isinstance(tree, dict):
        return {k: take(v, rows) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(take(v, rows) for v in tree)
    return tree[rows]


def minibatch_loss(net, params, stats, mb, ppo: dict, fault=None):
    """The loss of one minibatch ``mb`` (rows of the rollout record)."""
    if "carry" in mb:
        # Not reset where done, where that fault is planted.
        done = torch.zeros_like(mb["done"]) if fault == "carry_reset" else mb["done"]
        loglik, values, reg, final = net.replay(params, stats, mb["obs"], mb["extras"],
                                                carry=mb["carry"], done=done)
        with torch.no_grad():
            last_values = net.values(params, stats, mb["last_next_obs"], carry=final)
    else:
        loglik, values, reg = net.replay(params, stats, mb["obs"], mb["extras"])
        with torch.no_grad():
            last_values = net.values(params, stats, mb["last_next_obs"])
    keys = list(values)
    adv = {k: gae(mb["rewards"][k], values[k].detach(), last_values[k], mb["done"],
                  mb["truncated"], ppo["gae_lambda"], ppo["discounting_factor"]) for k in keys}
    if fault == "advantage":
        # An answer altered where it is produced: one env's advantages.
        adv = {k: torch.cat([a[:1] + 1.0, a[1:]]) for k, a in adv.items()}
    targets = {k: values[k].detach() + adv[k] for k in keys}
    a = functools.reduce(torch.add, [adv[k] for k in keys]) if ppo["combine_advantages"] else adv[keys[0]]
    if ppo["normalize_advantages"]:
        a = (a - a.mean()) / (a.std(correction=0) + 1e-8)
    clip = ppo["clip_range"]
    ratio = torch.exp(torch.clamp(loglik - mb["loglik"], -30.0, 30.0))
    surrogate = torch.minimum(ratio * a, torch.clamp(ratio, 1 - clip, 1 + clip) * a)
    critic_terms = [0.5 * torch.square(values[k] - targets[k]) for k in keys]
    reg_terms = reg
    if fault == "half_batch":
        # Half of the minibatch left out, the means taken over the rest.
        h = surrogate.shape[0] // 2
        surrogate, reg_terms = surrogate[:h], reg[:h]
        critic_terms = [c[:h] for c in critic_terms]
    actor = -torch.mean(surrogate)
    critic = functools.reduce(torch.add, [torch.mean(c) for c in critic_terms])
    return actor + ppo["critic_loss_weight"] * critic + reg_terms.mean()


def update(net, params: dict, m: dict, v: dict, count: int, stats, mb: dict, ppo: dict,
           fault=None) -> dict:
    """One minibatch update from ``params`` and Adam's moments ``m``, ``v``
    after ``count`` updates: the loss, its gradients, and the parameters
    and moments after the Adam step."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = minibatch_loss(net, leaves, stats, mb, ppo, fault)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    out = {"loss": loss.detach(), "grads": {}, "params": {}, "m": {}, "v": {}}
    for (name, p), g in zip(leaves.items(), grads):
        g = torch.zeros_like(p) if g is None else g
        out["grads"][name] = g
        out["params"][name], out["m"][name], out["v"][name] = adam_step(
            p.detach(), g, m[name], v[name], count + 1, ppo["learning_rate"])
    return out


def ppo_iteration(task, net, state: dict, ppo: dict, physics=None, fault=None,
                  follow=None, follow_controls=None) -> dict:
    """One iteration from ``state`` (see the module docstring). Each
    update starts from the last one's parameters and moments, or, where
    ``follow`` is given (a dict from an update's index to the
    ``{"params", "m", "v"}`` that another implementation started it
    from, or None for the iteration's own start), only the updates it
    names run, each from those; each control step likewise where
    ``follow_controls`` gives them (see :func:`rollout`). Returns the
    state after it with ``"controls"`` and ``"updates"``, by index: each
    update's loss, gradients, parameters and moments."""
    gen = state["generator"]
    params, m, v = state["params"], state["adam_m"], state["adam_v"]
    count = state["adam_count"]
    stats = state["stats"]
    B, T = ppo["n_envs"], ppo["rollout_length"]
    with torch.no_grad():
        env, rec = rollout(task, net, params, stats, state["env"], T, gen, physics,
                           follow_controls, state.get("carry"), fault)
    controls = rec.pop("controls")
    carry = rec.pop("final_carry", None)
    E, M = ppo["n_epochs"], ppo["n_minibatches"]
    perms = torch.stack([torch.randperm(B, generator=gen, device=gen.device)
                         for _ in range(E)]).reshape(E * M, B // M)
    history = rec.pop("history")
    updates = {}
    for j, rows in enumerate(perms):
        if follow is not None:
            if j not in follow:
                continue
            if follow[j] is not None:
                params, m, v = follow[j]["params"], follow[j]["m"], follow[j]["v"]
        done = update(net, params, m, v, count + j, stats, take(rec, rows), ppo, fault)
        updates[j] = done
        params, m, v = done["params"], done["m"], done["v"]
    if stats:
        stats = fold_moments(stats, history)
    out = {"params": params, "adam_m": m, "adam_v": v, "adam_count": count + len(perms),
           "stats": stats, "env": env, "generator": gen, "controls": controls,
           "updates": updates,
           "loss": torch.stack([u["loss"] for u in updates.values()]).mean()}
    if carry is not None:
        out["carry"] = carry
    return out
