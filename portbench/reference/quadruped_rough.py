"""The plain reference of the ``quadruped_rough`` configuration: the
legged joystick task (``legged.py``) and its actor-critic, from the
widths in ``configs/quadruped_rough.json``.

The network: one ReLU dense encoder per observation stream (command and
proprioception), concatenated in that order; the actor, dense ReLU then
dense to ``2 n_act`` (mean | raw std) and the tanh-squashed Normal; one
critic per reward key (penalty, tracking), dense ReLU then dense to 1.
"""

from __future__ import annotations

import torch

from portbench.reference.legged import LeggedTask
from portbench.reference.nets import dense, mlp, tanh_normal


def parameters(cfg: dict) -> list:
    """``(name, shape, fan_in)`` of every weight, kernels ``[in, out]``."""
    net, n_act = cfg["network"], cfg["env"]["n_act"]
    enc = net["encoder"]
    width = sum(enc.values())
    shapes = [(f"enc.{k}", (cfg["env"]["obs"][k], w)) for k, w in sorted(enc.items())]
    actor = [width, *net["actor_hidden"], 2 * n_act]
    critic = [width, *net["critic_hidden"], 1]
    shapes += [(f"actor.{i}", (a, b)) for i, (a, b) in enumerate(zip(actor[:-1], actor[1:]))]
    for key in cfg["reward_keys"]:
        shapes += [(f"critic.{key}.{i}", (a, b)) for i, (a, b) in enumerate(zip(critic[:-1], critic[1:]))]
    out = []
    for name, (a, b) in shapes:
        out += [(name + ".W", (a, b), a), (name + ".b", (b,), a)]
    return out


class Net:
    def __init__(self, cfg: dict, precision: str):
        self.cfg, self.precision = cfg, precision
        net = cfg["network"]
        self.streams = sorted(net["encoder"])
        self.n_actor = len(net["actor_hidden"]) + 1
        self.n_critic = len(net["critic_hidden"]) + 1
        self.keys = sorted(cfg["reward_keys"])

    def _trunk(self, params, obs):
        return torch.cat([dense(params, f"enc.{k}", obs[k], self.precision, relu=True)
                          for k in self.streams], dim=-1)

    def _head(self, params, h):
        return mlp(params, "actor", self.n_actor, h, self.precision)

    def _values(self, params, h):
        return {k: mlp(params, f"critic.{k}", self.n_critic, h, self.precision).squeeze(-1)
                for k in self.keys}

    def normalized_input(self, obs):
        return None

    def rollout(self, params, stats, obs, gen):
        mean_and_std = self._head(params, self._trunk(params, obs))
        shape = mean_and_std[..., : mean_and_std.shape[-1] // 2].shape
        noise = tuple(torch.randn(shape, generator=gen, device=gen.device) for _ in range(2))
        net = self.cfg["network"]
        action, loglik, _, extras = tanh_normal(mean_and_std, net["min_std"], net["entropy_weight"],
                                                noise=noise)
        return action, loglik, extras

    def replay(self, params, stats, obs, extras):
        h = self._trunk(params, obs)
        net = self.cfg["network"]
        _, loglik, reg, _ = tanh_normal(self._head(params, h), net["min_std"],
                                        net["entropy_weight"], extras=extras)
        return loglik, self._values(params, h), reg

    def values(self, params, stats, obs):
        return self._values(params, self._trunk(params, obs))


def task(cfg: dict, device) -> LeggedTask:
    return LeggedTask(cfg["env"], device)
