"""The system under test: the port's training step for one cell, built
from the cell's files and driven through ``ppo_step``.

The benchmark makes the weights itself, on the device, from the seed
(:func:`make_weights`), and hands the same dict to the port and to the
reference. :func:`snapshot` reads the training state between steps as
the reference reads it: parameters and Adam moments by the benchmark's
weight names, the normalizer's statistics, the env state, the network's
carry (where the configuration's module has ``carry_state``) and the
generator's state.
"""

from __future__ import annotations

import torch

from portbench import cells
from portbench.check import kept_updates

# The weights' stream is the seed's, moved away from the training
# generator's (which the port seeds with the seed itself).
WEIGHT_STREAM = 0x5DEECE66D


def make_weights(params: list, seed: int, device) -> dict:
    """Every ``(name, shape, fan_in)`` of ``params`` from one uniform draw
    on ``device``: kernels uniform in ``±sqrt(3 / fan_in)`` (variance
    scaling, fan in), biases uniform in ``±0.05``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 2654435761 + WEIGHT_STREAM) % (2**63))
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in params]
    u = 2.0 * torch.rand(sum(sizes), generator=gen, device=device) - 1.0
    out, offset = {}, 0
    for (name, shape, fan_in), n in zip(params, sizes):
        scale = (3.0 / fan_in) ** 0.5 if name.endswith(".W") else 0.05
        out[name] = (u[offset:offset + n] * scale).reshape(shape)
        offset += n
    return out


class Program:
    """The port's training state of one cell, from ``seed``."""

    def __init__(self, cell: dict, seed: int, device, weights: dict):
        from nnx_ppo_tpu_torch.algorithms import ppo

        self.ppo = ppo
        self.cell = cell
        module = cells.load_module("configs", cell["entry"]["config"])
        built = module.build(cell["config"], cell["traffic"])
        self.env_state = module.env_state
        self.carry_state = getattr(module, "carry_state", None)
        # Parameter-and-moment states copied to the host.
        self.state_copies = 0
        self.env, self.config, self.optimizer = built["env"], built["config"], built["optimizer"]
        self.port_names, self.stat_names = built["port_names"], built["stat_names"]
        self.state = ppo.new_training_state(self.env, built["networks"], self.config.n_envs, seed,
                                            optimizer=self.optimizer, device=device)
        named = dict(self.state.networks.named_parameters())
        with torch.no_grad():
            for ref, port in self.port_names.items():
                named[port].copy_(weights[ref])

    def step(self) -> dict:
        self.state, metrics = self.ppo.ppo_step(self.env, self.state, self.config, self.optimizer)
        return metrics

    def check_steps(self, n_steps: int, followed: list) -> tuple:
        """The first ``n_steps`` steps with their snapshots: the state
        before the first and after each, and with each step's snapshot
        its control steps and the updates ``followed`` needs. A control
        step is read where the rollout calls the env: the env state that
        enters ``step`` and the generator's state after ``reset`` (the
        env's own methods, wrapped on the instance for these steps). An
        update is read by a post-step hook on the training state's
        optimizer: the parameters and Adam's moments after it, copied
        only for the updates of :func:`kept_updates` (the last one's are
        the step's end). Where not every update is followed, each
        update's loss is read from ``ppo_update``'s metrics (the module's
        function, wrapped for these steps). All are removed after.
        Returns ``(snapshots, step losses)``."""
        named = dict(self.state.networks.named_parameters())
        opt = self.state.opt_state
        n = self.config.n_epochs * self.config.n_minibatches
        kept = set(kept_updates(followed, n))
        updates, controls, update_losses = {}, [], []
        seen = 0
        env, env_step, env_reset = self.env, self.env.step, self.env.reset
        ppo_update = self.ppo.ppo_update

        def step(state, action, generator=None):
            controls.append({"env": {k: v.detach().to("cpu", copy=True)
                                     for k, v in self.env_state(state).items()}})
            return env_step(state, action, generator)

        def reset(batch_size, generator):
            out = env_reset(batch_size, generator)
            if controls:
                controls[-1]["generator"] = generator.get_state()
            return out

        def after_update(optimizer, args, kwargs):
            nonlocal seen
            if seen in kept:
                self.state_copies += 1
                updates[seen] = {
                    "params": {r: named[p].detach().to("cpu", copy=True)
                               for r, p in self.port_names.items()},
                    "m": {r: opt.state[named[p]]["exp_avg"].to("cpu", copy=True)
                          for r, p in self.port_names.items()},
                    "v": {r: opt.state[named[p]]["exp_avg_sq"].to("cpu", copy=True)
                          for r, p in self.port_names.items()},
                }
            seen += 1

        def losses_of_each_update(*args, **kwargs):
            metrics = ppo_update(*args, **kwargs)
            update_losses.extend(update_totals(metrics).tolist())
            return metrics

        handle = opt.register_step_post_hook(after_update)
        env.step, env.reset = step, reset
        if len(followed) < n:
            self.ppo.ppo_update = losses_of_each_update
        snaps, losses = [self.snapshot()], []
        try:
            for _ in range(n_steps):
                losses.append(step_loss(self.step()).item())
                snaps.append(dict(self.snapshot(), updates=dict(updates), controls=list(controls),
                                  followed=followed, n_updates=seen,
                                  update_losses=list(update_losses)))
                updates.clear()
                controls.clear()
                update_losses.clear()
                seen = 0
        finally:
            handle.remove()
            del env.step, env.reset
            self.ppo.ppo_update = ppo_update
        return snaps, losses

    def snapshot(self) -> dict:
        """The training state as the reference reads it, copied to the host."""
        ts = self.state
        named = dict(ts.networks.named_parameters())
        buffers = dict(ts.networks.named_buffers())
        opt = ts.opt_state
        copy = lambda x: x.detach().to("cpu", copy=True)  # noqa: E731
        self.state_copies += 1
        snap = {
            "params": {r: copy(named[p]) for r, p in self.port_names.items()},
            "adam_m": {r: copy(opt.state[named[p]]["exp_avg"]) for r, p in self.port_names.items()},
            "adam_v": {r: copy(opt.state[named[p]]["exp_avg_sq"])
                       for r, p in self.port_names.items()},
            "adam_count": int(opt.param_groups[0]["update_count"]),
            "stats": {r: copy(buffers[p]) for r, p in self.stat_names.items()},
            "env": {k: copy(v) for k, v in self.env_state(ts.env_states).items()},
            "generator": ts.generator.get_state(),
        }
        if self.carry_state is not None:
            snap["carry"] = {k: copy(v) for k, v in self.carry_state(ts.network_states).items()}
        return snap


def step_loss(metrics: dict) -> torch.Tensor:
    """A step's loss, the mean over its updates of the total loss, from
    the port's metrics (every critic weighs 1 in these configurations):
    the actor's, each critic's and the regularization's means."""
    parts = [v for k, v in metrics.items()
             if k.startswith(("losses/actor", "losses/critic", "losses/regularization"))
             and k.endswith("/mean")]
    return torch.stack([torch.as_tensor(p, dtype=torch.float32) for p in parts]).sum()


def update_totals(metrics: dict) -> torch.Tensor:
    """Each update's total loss, ``[E M]``, from ``ppo_update``'s loss
    metrics stacked over the updates: the actor's, each critic's and
    the regularization's."""
    from nnx_ppo_tpu_torch.core.struct import tree_leaves

    parts = [metrics[k] for k in ("losses/actor", "losses/critic", "losses/regularization")]
    return torch.stack(tree_leaves(parts)).sum(dim=0)
