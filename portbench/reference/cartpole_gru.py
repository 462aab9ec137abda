"""The plain reference of the ``cartpole_gru`` configuration: cart-pole
balance (``cartpole.py``) with no observation normalizer, a GRU actor
(GRU, then a dense layer to ``2 n_act`` and the tanh-squashed Normal)
and a GRU critic (GRU, then a dense layer to 1), every matrix product in
the configuration's precision.

The GRU is flax's ``GRUCell`` as the JAX package writes it: fused
kernels ``Wi [in, 3H]`` and ``Wh [H, 3H]``, one bias on the input side,
gates ``(r, z, n)``, ``n = tanh(x Wi_n + b_n + r (h Wh_n))``,
``h' = (1 - z) n + z h``. The carry is each GRU's ``h``, ``[B, H]``,
zero at the start and reset to zero where an episode ends. The replay
runs the cells over a minibatch's ``[b, T]`` rows from the carry its
rows started the rollout with, resetting where ``done``, and hands back
the carry after the last step for the bootstrap value.
"""

from __future__ import annotations

import torch

from portbench.reference.cartpole import CartpoleTask
from portbench.reference.nets import dense, tanh_normal
from portbench.reference.precision import matmul

PORTS = ("actor", "critic")


def parameters(cfg: dict) -> list:
    """``(name, shape, fan_in)`` of every weight, kernels ``[in, out]``."""
    n_obs, n_act, h = cfg["env"]["obs"], cfg["env"]["n_act"], cfg["network"]["hidden"]
    out = []
    for name, n_out in (("actor", 2 * n_act), ("critic", 1)):
        out += [(f"{name}.gru.in.W", (n_obs, 3 * h), n_obs), (f"{name}.gru.rec.W", (h, 3 * h), h),
                (f"{name}.gru.b", (3 * h,), n_obs),
                (f"{name}.out.W", (h, n_out), h), (f"{name}.out.b", (n_out,), h)]
    return out


class Net:
    def __init__(self, cfg: dict, precision: str):
        self.cfg, self.precision = cfg, precision

    def normalized_input(self, obs):
        return None

    def initial_carry(self, B: int, device) -> dict:
        h = self.cfg["network"]["hidden"]
        return {f"{p}.h": torch.zeros((B, h), device=device) for p in PORTS}

    def reset_carry(self, carry: dict, done: torch.Tensor) -> dict:
        return {k: torch.where(done[:, None], torch.zeros_like(h), h) for k, h in carry.items()}

    def _gru(self, params, port: str, xi, h):
        """One cell step from the input half ``xi = x Wi + b``."""
        hh = matmul(h, params[f"{port}.gru.rec.W"], self.precision)
        xr, xz, xn = torch.chunk(xi, 3, dim=-1)
        hr, hz, hn = torch.chunk(hh, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h

    def _input(self, params, port: str, x):
        return matmul(x, params[f"{port}.gru.in.W"], self.precision) + params[f"{port}.gru.b"]

    def _steps(self, params, obs, carry):
        """Both cells one step from ``carry``: the new carry."""
        return {f"{p}.h": self._gru(params, p, self._input(params, p, obs), carry[f"{p}.h"])
                for p in PORTS}

    def _out(self, params, port: str, h):
        return dense(params, f"{port}.out", h, self.precision, relu=False)

    def rollout(self, params, stats, obs, gen, carry):
        nxt = self._steps(params, obs, carry)
        mean_and_std = self._out(params, "actor", nxt["actor.h"])
        shape = mean_and_std[..., : mean_and_std.shape[-1] // 2].shape
        noise = tuple(torch.randn(shape, generator=gen, device=gen.device) for _ in range(2))
        net = self.cfg["network"]
        action, loglik, _, extras = tanh_normal(mean_and_std, net["min_std"], net["entropy_weight"],
                                                noise=noise)
        return action, loglik, extras, nxt

    def replay(self, params, stats, obs, extras, carry, done):
        """``obs [b, T, f]``, ``done [b, T]``: the log-likelihoods, values
        and entropy costs ``[b, T]``, and the carry after the last step."""
        xi = {p: self._input(params, p, obs) for p in PORTS}
        outs = {p: [] for p in PORTS}
        for t in range(done.shape[1]):
            carry = {f"{p}.h": self._gru(params, p, xi[p][:, t], carry[f"{p}.h"]) for p in PORTS}
            for p in PORTS:
                outs[p].append(carry[f"{p}.h"])
            carry = self.reset_carry(carry, done[:, t])
        h = {p: torch.stack(outs[p], dim=1) for p in PORTS}
        net = self.cfg["network"]
        _, loglik, reg, _ = tanh_normal(self._out(params, "actor", h["actor"]), net["min_std"],
                                        net["entropy_weight"], extras=extras)
        return loglik, {"reward": self._out(params, "critic", h["critic"]).squeeze(-1)}, reg, carry

    def values(self, params, stats, obs, carry):
        h = self._gru(params, "critic", self._input(params, "critic", obs), carry["critic.h"])
        return {"reward": self._out(params, "critic", h).squeeze(-1)}


def task(cfg: dict, device) -> CartpoleTask:
    return CartpoleTask(cfg["env"], device)
