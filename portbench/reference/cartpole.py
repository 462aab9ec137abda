"""Cart-pole balance of the reference, batched over envs (Barto, Sutton
and Anderson 1983, with the dm_control-style smooth reward): state
``q = (x, theta, x_dot, theta_dot)``, semi-implicit Euler at 0.02 s,
termination when the cart leaves ``|x| <= 2.4`` or the pole passes
``|theta| = 0.8``, a time limit, and auto-reset near upright. The state
is one flat dict of ``[B, ...]`` tensors."""

from __future__ import annotations

import torch

GRAVITY, CART_MASS, POLE_MASS, HALF_LENGTH = 9.8, 1.0, 0.1, 0.5
FORCE, DT, X_LIMIT, ANGLE_LIMIT = 10.0, 0.02, 2.4, 0.8


def _tolerance(x, bound: float, margin: float):
    d = torch.clamp(torch.abs(x) - bound, min=0.0)
    return torch.exp(-0.5 * (d / margin) ** 2)


class CartpoleTask:
    def __init__(self, env_cfg: dict, device):
        self.cfg, self.device = env_cfg, device

    def _derived(self, q) -> dict:
        x, theta, x_dot, theta_dot = q.unbind(-1)
        cos_t = torch.cos(theta)
        upright = (cos_t + 1.0) / 2.0
        centered = _tolerance(x, 0.25, 1.0)
        small_velocity = _tolerance(theta_dot, 0.5, 2.0)
        return {
            "q": q,
            "obs": torch.stack([x, cos_t, torch.sin(theta), x_dot, theta_dot], dim=-1),
            "reward": upright * (1.0 + centered) / 2.0 * (1.0 + small_velocity) / 2.0,
            "fallen": (torch.abs(x) > X_LIMIT) | (torch.abs(theta) > ANGLE_LIMIT),
        }

    def reset(self, B: int, gen: torch.Generator) -> dict:
        noise = torch.randn((B, 4), generator=gen, device=self.device)
        s = self._derived(0.05 * noise)
        s["step_counter"] = torch.randint(0, self.cfg["episode_length"] // 2, (B,), generator=gen,
                                          device=self.device, dtype=torch.int32)
        s["truncated"] = torch.zeros(B, dtype=torch.bool, device=self.device)
        s["done"] = s.pop("fallen").to(torch.float32)
        return s

    def step(self, s: dict, action, gen: torch.Generator, physics=None) -> dict:
        q = s["q"]
        x, theta, x_dot, theta_dot = q.unbind(-1)
        force = FORCE * torch.clamp(action, -1.0, 1.0).reshape(q.shape[0])
        total = CART_MASS + POLE_MASS
        ml = POLE_MASS * HALF_LENGTH
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        temp = (force + ml * theta_dot**2 * sin_t) / total
        theta_acc = (GRAVITY * sin_t - cos_t * temp) / (
            HALF_LENGTH * (4.0 / 3.0 - POLE_MASS * cos_t**2 / total))
        x_acc = temp - ml * theta_acc * cos_t / total
        x_dot = x_dot + DT * x_acc
        theta_dot = theta_dot + DT * theta_acc
        x = x + DT * x_dot
        theta = theta + DT * theta_dot
        n = self._derived(torch.stack([x, theta, x_dot, theta_dot], dim=-1))
        n["step_counter"] = s["step_counter"] + 1
        n["truncated"] = n["step_counter"] >= self.cfg["episode_length"]
        n["done"] = (n.pop("fallen") | n["truncated"]).to(torch.float32)
        return n

    def obs(self, s: dict):
        return s["obs"]

    def rewards(self, s: dict) -> dict:
        return {"reward": s["reward"]}
