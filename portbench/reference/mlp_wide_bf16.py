"""The plain reference of the ``mlp_wide_bf16`` configuration: cart-pole
balance (``cartpole.py``) behind an observation normalizer, a wide MLP
actor (tanh-squashed Normal head) and a wide MLP critic, every matrix
product in the configuration's precision (bf16 operands, float32 sums)."""

from __future__ import annotations

from portbench.reference.cartpole import CartpoleTask
from portbench.reference.nets import mlp, normalize, tanh_normal

import torch


def parameters(cfg: dict) -> list:
    """``(name, shape, fan_in)`` of every weight, kernels ``[in, out]``."""
    net, n_obs, n_act = cfg["network"], cfg["env"]["obs"], cfg["env"]["n_act"]
    out = []
    for name, sizes in (("actor", [n_obs, *net["actor_hidden"], 2 * n_act]),
                        ("critic", [n_obs, *net["critic_hidden"], 1])):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out += [(f"{name}.{i}.W", (a, b), a), (f"{name}.{i}.b", (b,), a)]
    return out


def initial_stats(cfg: dict, device) -> dict:
    n = cfg["env"]["obs"]
    return {"count": torch.zeros((), device=device), "mean": torch.zeros(n, device=device),
            "M2": torch.zeros(n, device=device)}


class Net:
    def __init__(self, cfg: dict, precision: str):
        self.cfg, self.precision = cfg, precision
        self.n_actor = len(cfg["network"]["actor_hidden"]) + 1
        self.n_critic = len(cfg["network"]["critic_hidden"]) + 1

    def normalized_input(self, obs):
        return obs

    def _head(self, params, x):
        return mlp(params, "actor", self.n_actor, x, self.precision)

    def _values(self, params, x):
        return {"reward": mlp(params, "critic", self.n_critic, x, self.precision).squeeze(-1)}

    def rollout(self, params, stats, obs, gen):
        x = normalize(stats, obs)
        mean_and_std = self._head(params, x)
        shape = mean_and_std[..., : mean_and_std.shape[-1] // 2].shape
        noise = tuple(torch.randn(shape, generator=gen, device=gen.device) for _ in range(2))
        net = self.cfg["network"]
        action, loglik, _, extras = tanh_normal(mean_and_std, net["min_std"], net["entropy_weight"],
                                                noise=noise)
        return action, loglik, extras

    def replay(self, params, stats, obs, extras):
        x = normalize(stats, obs)
        net = self.cfg["network"]
        _, loglik, reg, _ = tanh_normal(self._head(params, x), net["min_std"],
                                        net["entropy_weight"], extras=extras)
        return loglik, self._values(params, x), reg

    def values(self, params, stats, obs):
        return self._values(params, normalize(stats, obs))


def task(cfg: dict, device) -> CartpoleTask:
    return CartpoleTask(cfg["env"], device)
