"""The plain reference of the ``granite_h_micro`` configuration: cart-pole
balance (``cartpole.py``) behind an observation normalizer, and one
period of IBM Granite 4.0-H Micro (``granitemoehybrid``, the published
``config.json``) as the trunk shared by a tanh-squashed Normal actor head
and a value head, every matrix product in the configuration's precision
(``precision.py``) and everything else in float32.

The model as published, layer ``i`` of kind ``layer_types[i]``::

    h = h + r mixer(rmsnorm(h))       h = h + r mlp(rmsnorm(h))

with ``r`` the residual multiplier 0.22, RMSNorm ``x / sqrt(mean(x^2) +
eps) w``, and the SwiGLU MLP ``output(silu(a) b)``, ``[a, b] =
input(x)``. A Mamba-2 mixer (Dao & Gu, arXiv:2405.21060): ``in_proj`` to
``[z, xBC, dt]``; a causal depthwise convolution of ``K`` taps with bias
over ``xBC``, then SiLU; ``x`` in ``H`` heads of ``P``, one group of ``B``
and ``C`` of ``N``; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
step by step, ``h_t = exp(dt A) h_(t-1) + dt x_t B_t`` and ``y_t = h_t C_t
+ D x_t``; the gated RMSNorm ``rmsnorm(y silu(z)) w``; ``out_proj``. The
attention mixer: 32 query heads over 8 key/value heads (each key/value
head repeated for its 4 query heads), scores ``q.k`` times the attention
multiplier, causal, with no positional encoding and no bias.

This reference runs the Mamba-2 recurrence one step at a time (not the
chunked SSD the program replays with) and attention as full causal
attention over the positions of the episode so far, kept in a cache that
each step appends to; both are reset where an episode ends (after the
step). The projections of a layer are taken over all steps at once.

Departures from the published model, each a choice of the
configuration's file: ten layers, one period of the forty (``reduced``);
no vocabulary and no LM head: a projection ``Dense(obs -> hidden)`` of the
normalized observation with no bias, times the embedding multiplier, in
place of the token embedding, and after the final RMSNorm ``Dense(hidden
-> 2 n_act)`` into the tanh-squashed Normal and ``Dense(hidden -> 1)`` for
the value in place of the tied LM head (so ``logits_scaling`` is unused);
the attention cache holds the episode's limit of positions.

The carry is a flat dict by layer: ``layers.i.ssm [B, H, P, N]`` and
``layers.i.conv [B, K - 1, C]`` (the convolution's last inputs, oldest
first) for a Mamba layer, ``layers.i.k`` and ``layers.i.v [B, capacity, 8,
64]`` and ``layers.i.length [B]`` for the attention layer.

The backward through 128 steps of nine recurrences would hold some 40 GB
for a minibatch of 16 rows, so the replay's gradient is taken in blocks
of rows (:class:`_RowBlocks`): the forward runs every row without a
graph, and the backward runs each block's forward again with one and
takes its gradient, one block at a time.
"""

from __future__ import annotations

import torch

from portbench.reference.cartpole import CartpoleTask
from portbench.reference.mlp_wide_bf16 import initial_stats  # noqa: F401  (the same normalizer)
from portbench.reference.nets import normalize, softplus, tanh_normal
from portbench.reference.precision import ROUNDINGS, _RoundThrough, round_bf16

# Rows of a minibatch whose replay one backward block holds.
ROWS_PER_BLOCK = 4
# RMSNorm weights are drawn as kernels of this fan-in: uniform in +-1.
NORM_FAN_IN = 3


def sizes(cfg: dict) -> dict:
    D, H, P = cfg["hidden_size"], cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N, G = cfg["mamba_d_state"], cfg["num_key_value_heads"]
    assert cfg["mamba_n_groups"] == 1 and H * P == cfg["mamba_expand"] * D
    return {"D": D, "H": H, "P": P, "N": N, "K": cfg["mamba_d_conv"], "I": H * P,
            "C": H * P + 2 * N, "Q": cfg["num_attention_heads"], "G": G,
            "Dh": D // cfg["num_attention_heads"], "F": cfg["shared_intermediate_size"],
            "cap": cfg["network"]["kv_cache_capacity"]}


def parameters(cfg: dict) -> list:
    """``(name, shape, fan_in)`` of every weight, kernels ``[in, out]``."""
    s, n_obs, n_act = sizes(cfg), cfg["env"]["obs"], cfg["env"]["n_act"]
    D = s["D"]
    out = [("embed.W", (n_obs, D), n_obs)]
    for i, kind in enumerate(cfg["layer_types"]):
        pre = f"layers.{i}"
        out.append((f"{pre}.input_norm.W", (D,), NORM_FAN_IN))
        if kind == "mamba":
            out += [(f"{pre}.mamba.in_proj.W", (D, s["I"] + s["C"] + s["H"]), D),
                    (f"{pre}.mamba.conv.W", (s["K"], s["C"]), s["K"]),
                    (f"{pre}.mamba.conv.b", (s["C"],), s["K"]),
                    (f"{pre}.mamba.dt_bias", (s["H"],), 1), (f"{pre}.mamba.A_log", (s["H"],), 1),
                    (f"{pre}.mamba.D", (s["H"],), 1),
                    (f"{pre}.mamba.norm.W", (s["I"],), NORM_FAN_IN),
                    (f"{pre}.mamba.out_proj.W", (s["I"], D), s["I"])]
        else:
            q, kv = s["Q"] * s["Dh"], s["G"] * s["Dh"]
            out += [(f"{pre}.attention.q.W", (D, q), D), (f"{pre}.attention.k.W", (D, kv), D),
                    (f"{pre}.attention.v.W", (D, kv), D), (f"{pre}.attention.o.W", (q, D), q)]
        out += [(f"{pre}.post_norm.W", (D,), NORM_FAN_IN),
                (f"{pre}.mlp.input.W", (D, 2 * s["F"]), D), (f"{pre}.mlp.output.W", (s["F"], D), s["F"])]
    out += [("final_norm.W", (D,), NORM_FAN_IN), ("actor.W", (D, 2 * n_act), D),
            ("actor.b", (2 * n_act,), D), ("critic.W", (D, 1), D), ("critic.b", (1,), D)]
    return out


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rounded_kernel(w: torch.Tensor, precision: str) -> torch.Tensor:
    """A kernel as ``precision.matmul`` rounds it, with the gradient its
    rounding passes back. Rounded once for a whole minibatch, before the
    blocks of rows: bf16's cast rounds the kernel's gradient, and it must
    round the minibatch's gradient, as the port's layer does, not each
    block's."""
    base = precision.split("/")[0]
    if base == "bfloat16":
        return round_bf16(w)
    fn = ROUNDINGS[base]
    return w if fn is None else _RoundThrough.apply(w, fn)


def product(x: torch.Tensor, wr: torch.Tensor, precision: str) -> torch.Tensor:
    """``precision.matmul(x, w, precision)`` for ``wr = rounded_kernel(w)``:
    ``x`` rounded as that rounds it, the kernel taken as it comes."""
    if precision.endswith("/split"):
        base, h = precision[: -len("/split")], wr.shape[0] // 2
        return product(x[..., :h], wr[:h], base) + product(x[..., h:], wr[h:], base)
    if precision == "bfloat16":
        return torch.matmul(round_bf16(x), wr)
    fn = ROUNDINGS[precision]
    return torch.matmul(x if fn is None else _RoundThrough.apply(x, fn), wr)


class _RowBlocks(torch.autograd.Function):
    """``run(params, rows)`` over every row without a graph; its backward
    runs ``run`` again on each block of ``block`` rows with a graph and
    takes the gradient of the parameters from it, block by block. The
    first ``n_grad`` outputs carry gradients; the rest (the final carry)
    do not."""

    @staticmethod
    def forward(ctx, run, block: int, n_params: int, n_grad: int, *tensors):
        ctx.run, ctx.block, ctx.n_params, ctx.n_grad = run, block, n_params, n_grad
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            outs = run(tensors[:n_params], tensors[n_params:])
        ctx.mark_non_differentiable(*outs[n_grad:])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        params, rows = tensors[:ctx.n_params], tensors[ctx.n_params:]
        total = [torch.zeros_like(p) for p in params]
        for r0 in range(0, rows[0].shape[0], ctx.block):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(True) for p in params]
                outs = ctx.run(leaves, [r[r0:r0 + ctx.block] for r in rows])[:ctx.n_grad]
                pairs = [(o, g[r0:r0 + ctx.block]) for o, g in zip(outs, grads) if g is not None]
                got = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                                          allow_unused=True)
            total = [t if g is None else t + g for t, g in zip(total, got)]
        return (None, None, None, None, *total, *([None] * len(rows)))


class Net:
    def __init__(self, cfg: dict, precision: str):
        self.cfg, self.precision = cfg, precision
        self.s = sizes(cfg)
        self.eps, self.r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
        # The kernels of the matrix products (not the norms' weights or
        # the convolution's taps).
        self.kernels = {n for n, _, _ in parameters(cfg)
                        if n.endswith(".W") and not n.endswith(("norm.W", "conv.W"))}

    def normalized_input(self, obs):
        return obs

    def _rounded(self, params: dict) -> dict:
        return {k: rounded_kernel(v, self.precision) if k in self.kernels else v
                for k, v in params.items()}

    def _mm(self, x, params, name):
        """``x`` times the kernel ``name`` of :meth:`_rounded` params."""
        return product(x, params[name + ".W"], self.precision)

    # -- the carry ------------------------------------------------------------------

    def initial_carry(self, B: int, device) -> dict:
        s, out = self.s, {}
        for i, kind in enumerate(self.cfg["layer_types"]):
            if kind == "mamba":
                out[f"layers.{i}.ssm"] = torch.zeros((B, s["H"], s["P"], s["N"]), device=device)
                out[f"layers.{i}.conv"] = torch.zeros((B, s["K"] - 1, s["C"]), device=device)
            else:
                for n in ("k", "v"):
                    out[f"layers.{i}.{n}"] = torch.zeros((B, s["cap"], s["G"], s["Dh"]),
                                                         device=device)
                out[f"layers.{i}.length"] = torch.zeros(B, dtype=torch.long, device=device)
        return out

    def reset_carry(self, carry: dict, done: torch.Tensor) -> dict:
        return {k: torch.where(done.reshape((-1,) + (1,) * (v.ndim - 1)), torch.zeros_like(v), v)
                for k, v in carry.items()}

    # -- one step of each mixer -----------------------------------------------------

    def _mamba_step(self, params, m: str, z, xbc, dt, ssm, conv):
        """The recurrence's step from the projections of one step's input:
        ``(y, ssm, conv)``."""
        s = self.s
        window = torch.cat([conv, xbc[:, None]], dim=1)  # [r, K, C]
        xbc = torch.nn.functional.silu((window * params[m + ".conv.W"]).sum(1)
                                       + params[m + ".conv.b"])
        x, B, C = torch.split(xbc, [s["I"], s["N"], s["N"]], dim=-1)
        x = x.reshape(-1, s["H"], s["P"])
        dt = softplus(dt + params[m + ".dt_bias"])
        A = -torch.exp(params[m + ".A_log"])
        ssm = (torch.exp(dt * A)[:, :, None, None] * ssm
               + (dt[:, :, None] * x)[..., None] * B[:, None, None, :])
        y = (ssm * C[:, None, None, :]).sum(-1) + params[m + ".D"][:, None] * x
        y = rmsnorm(y.reshape(-1, s["I"]) * torch.nn.functional.silu(z), params[m + ".norm.W"],
                    self.eps)
        return y, ssm, window[:, 1:]

    def _attention_step(self, q, k, v, carry: dict, pre: str):
        """One query over the episode's positions, the new one appended."""
        s = self.s
        rows = torch.arange(q.shape[0], device=q.device)
        length = carry[pre + ".length"]
        keys = carry[pre + ".k"].index_put((rows, length), k)
        values = carry[pre + ".v"].index_put((rows, length), v)
        length = length + 1
        rep = s["Q"] // s["G"]
        kq = keys.repeat_interleave(rep, dim=2)  # [r, cap, Q, Dh]
        vq = values.repeat_interleave(rep, dim=2)
        scores = torch.einsum("rqd,rjqd->rqj", q, kq) * self.cfg["attention_multiplier"]
        seen = torch.arange(s["cap"], device=q.device)[None, :] < length[:, None]
        weights = torch.softmax(scores.masked_fill(~seen[:, None], float("-inf")), dim=-1)
        y = torch.einsum("rqj,rjqd->rqd", weights, vq).reshape(q.shape[0], -1)
        return y, {pre + ".k": keys, pre + ".v": values, pre + ".length": length}

    # -- the trunk --------------------------------------------------------------------

    def _trunk(self, params, x, carry: dict, done=None):
        """``x [r, T, obs]`` (normalized) from ``carry``: the final norm's
        output ``[r, T, D]`` and the carry after the last step, reset after
        each step ``t`` where ``done[:, t]`` (none without ``done``)."""
        s = self.s
        T = x.shape[1]
        h = self._mm(x, params, "embed") * self.cfg["embedding_multiplier"]
        carry = dict(carry)
        for i, kind in enumerate(self.cfg["layer_types"]):
            pre = f"layers.{i}"
            u = rmsnorm(h, params[pre + ".input_norm.W"], self.eps)
            mine = {k: v for k, v in carry.items() if k.startswith(pre + ".")}
            ys = []
            if kind == "mamba":
                m = pre + ".mamba"
                z, xbc, dt = torch.split(self._mm(u, params, m + ".in_proj"),
                                         [s["I"], s["C"], s["H"]], dim=-1)
                for t in range(T):
                    y, ssm, conv = self._mamba_step(params, m, z[:, t], xbc[:, t], dt[:, t],
                                                    mine[pre + ".ssm"], mine[pre + ".conv"])
                    ys.append(y)
                    new = {pre + ".ssm": ssm, pre + ".conv": conv}
                    mine = new if done is None else self.reset_carry(new, done[:, t])
                y = self._mm(torch.stack(ys, dim=1), params, m + ".out_proj")
            else:
                a = pre + ".attention"
                q = self._mm(u, params, a + ".q").unflatten(-1, (s["Q"], s["Dh"]))
                k = self._mm(u, params, a + ".k").unflatten(-1, (s["G"], s["Dh"]))
                v = self._mm(u, params, a + ".v").unflatten(-1, (s["G"], s["Dh"]))
                for t in range(T):
                    y, new = self._attention_step(q[:, t], k[:, t], v[:, t], mine, pre)
                    ys.append(y)
                    mine = new if done is None else self.reset_carry(new, done[:, t])
                y = self._mm(torch.stack(ys, dim=1), params, a + ".o")
            carry.update(mine)
            h = h + self.r * y
            u = rmsnorm(h, params[pre + ".post_norm.W"], self.eps)
            a_, b_ = torch.chunk(self._mm(u, params, pre + ".mlp.input"), 2, dim=-1)
            h = h + self.r * self._mm(torch.nn.functional.silu(a_) * b_, params, pre + ".mlp.output")
        return rmsnorm(h, params["final_norm.W"], self.eps), carry

    def _heads(self, params, h):
        return (self._mm(h, params, "actor") + params["actor.b"],
                (self._mm(h, params, "critic") + params["critic.b"]).squeeze(-1))

    # -- the network's interface ------------------------------------------------------

    def rollout(self, params, stats, obs, gen, carry):
        params = self._rounded(params)
        h, carry = self._trunk(params, normalize(stats, obs)[:, None], carry)
        mean_and_std, _ = self._heads(params, h[:, 0])
        shape = mean_and_std[..., : mean_and_std.shape[-1] // 2].shape
        noise = tuple(torch.randn(shape, generator=gen, device=gen.device) for _ in range(2))
        net = self.cfg["network"]
        action, loglik, _, extras = tanh_normal(mean_and_std, net["min_std"], net["entropy_weight"],
                                                noise=noise)
        return action, loglik, extras, carry

    def replay(self, params, stats, obs, extras, carry, done):
        """``obs [b, T, f]``, ``done [b, T]``: the log-likelihoods, values and
        entropy costs ``[b, T]`` and the carry after the last step, from
        each row's start ``carry``; the gradient in blocks of
        :data:`ROWS_PER_BLOCK` rows, of the kernels as rounded for the
        whole minibatch (:func:`rounded_kernel`)."""
        params = self._rounded(params)
        names = list(params)
        carry_keys = list(carry)
        net = self.cfg["network"]

        def run(values, rows):
            p = dict(zip(names, values))
            obs_r, raw, noise, done_r = rows[:4]
            h, final = self._trunk(p, normalize(stats, obs_r), dict(zip(carry_keys, rows[4:])),
                                   done_r)
            mean_and_std, value = self._heads(p, h)
            _, loglik, reg, _ = tanh_normal(mean_and_std, net["min_std"], net["entropy_weight"],
                                            extras=(raw, noise))
            return (loglik, value, reg, *(final[k] for k in carry_keys))

        raw, noise = extras
        outs = _RowBlocks.apply(run, ROWS_PER_BLOCK, len(names), 3, *params.values(), obs, raw,
                                noise, done, *carry.values())
        loglik, value, reg = outs[:3]
        return loglik, {"reward": value}, reg, dict(zip(carry_keys, outs[3:]))

    def values(self, params, stats, obs, carry):
        params = self._rounded(params)
        h, _ = self._trunk(params, normalize(stats, obs)[:, None], carry)
        return {"reward": self._heads(params, h[:, 0])[1]}


def task(cfg: dict, device) -> CartpoleTask:
    return CartpoleTask(cfg["env"], device)
