"""A hybrid trunk of Mamba-2 mixers and grouped-query attention, as the
``granitemoehybrid`` models (IBM Granite 4.0-H) stack them, for a policy
whose memory of the episode is its carry. No JAX counterpart: the JAX
package has no attention or state-space layer.

Each layer is ``h = h + r mixer(norm(h))`` then ``h = h + r mlp(norm(h))``
(``r`` the residual multiplier), with RMSNorms and a SwiGLU MLP; the
mixer is a Mamba-2 layer (Dao & Gu, arXiv:2405.21060) or causal attention
with no positional encoding. :class:`HybridTrunk` scales its input by the
embedding multiplier, runs the layers and a final RMSNorm.

Every projection is a :class:`~nnx_ppo_tpu_torch.networks.feedforward.Dense`
in the layer's ``compute_dtype``; the state-space recurrence, the
convolution, the norms, the softmax and attention's score and value
products are float32.

Carries, per env, reset to zeros where an episode ends:

* Mamba-2: the SSM state ``[H, P, N]`` and the convolution's last
  ``K - 1`` inputs ``[K - 1, C]`` (``C`` = intermediate + 2 N);
* attention: a key and a value cache ``[capacity, KV heads, head dim]``
  and the number of positions held. The capacity must be at least the
  episode's limit: a write past it raises (an index out of range).

The step form (``forward``) is the rollout's: the Mamba state update
through :func:`~nnx_ppo_tpu_torch.ops.ssm_step.ssm_step` (a CUDA kernel on
the card), attention over the cache's valid prefix after appending. The
replay (``replay_sequence``, time-major ``[T, b]``) starts from each row's
carry and resets at every ``done`` inside the row: the convolution's taps
and the SSD's decays are cut at episode boundaries (the segment of each
step is the number of ``done`` before it), the SSD is chunked (the
segment sum of ``dt A`` within each chunk, the state passed from chunk to
chunk), and attention runs over the start cache and the row's steps
under a mask of the episode. Outputs and carries equal the step form's
(tests/test_torch_hybrid.py).

Each mixer's and MLP's work runs inside a profiler span (``net.mamba``,
``net.attention``, ``net.mlp``). The trunk's step reports the attention
cache's length per env under ``metrics["counters"]``, which ``ppo_step``
reads at the rollout's last step.

The trunk's step on a card, without gradients (the rollout's), is
captured once per input shape as a CUDA graph and replayed:
the same kernels on the same numbers, launched by one call instead of the
host launching a thousand small operations a control step, which left
the card idle more than half the rollout. The carry it returns is the
graph's own output, written again by the next replay: a caller takes it
up before the next step, as ``unroll_env``'s reset and select do, or
passes it straight to the next step, as ``eval_rollout`` does (the
replay copies its input carry into the graph's own first), and keeps
none of it past that. A graph is captured anew when a parameter has been
replaced rather than updated in place. Each replay counts one launch of
the SSM step kernel per Mamba layer (``ssm_step_cuda.launches``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_map
from nnx_ppo_tpu_torch.networks.feedforward import Dense
from nnx_ppo_tpu_torch.networks.types import ModuleOutput, StatefulModule
from nnx_ppo_tpu_torch.ops import cuda_build
from nnx_ppo_tpu_torch.ops.ssm_step import ssm_step, ssm_step_cuda
from nnx_ppo_tpu_torch.utils.profiling import span

DType = Union[None, str, torch.dtype]


def _project(dense: Dense, x: torch.Tensor) -> torch.Tensor:
    return dense((), x).output


def segments(done: torch.Tensor) -> torch.Tensor:
    """``[T, b]``: the number of episode ends before each step of a row,
    so that two steps of a row share an episode where they are equal."""
    d = done.long()
    return torch.cumsum(d, 0) - d


class RMSNorm(StatefulModule):
    """``x / sqrt(mean(x^2) + eps) * weight`` over the last axis; with a
    ``gate``, of ``x * silu(gate)`` (Mamba-2's gated norm)."""

    def __init__(self, weight: torch.Tensor, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.eps = eps

    @classmethod
    def create(cls, dim: int, eps: float = 1e-5) -> "RMSNorm":
        return cls(torch.ones(dim), eps)

    def normalize(self, x: torch.Tensor, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        if gate is not None:
            x = x * nn.functional.silu(gate)
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        return ModuleOutput((), self.normalize(x), 0.0, {}, None)

    @property
    def replay_time_static(self) -> bool:
        return True


class SwiGLU(StatefulModule):
    """``output_linear(silu(a) * b)`` with ``[a, b] = input_linear(x)``."""

    def __init__(self, input_linear: Dense, output_linear: Dense):
        super().__init__()
        self.input_linear = input_linear
        self.output_linear = output_linear

    @classmethod
    def create(cls, hidden: int, intermediate: int, generator: torch.Generator,
               compute_dtype: DType = None) -> "SwiGLU":
        return cls(
            Dense.create(hidden, 2 * intermediate, generator, use_bias=False,
                         compute_dtype=compute_dtype),
            Dense.create(intermediate, hidden, generator, use_bias=False,
                         compute_dtype=compute_dtype),
        )

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        with span("net.mlp"):
            a, b = _project(self.input_linear, x).chunk(2, dim=-1)
            return _project(self.output_linear, nn.functional.silu(a) * b)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        return ModuleOutput((), self.mlp(x), 0.0, {}, None)

    @property
    def replay_time_static(self) -> bool:
        return True


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """``[..., L, L]``: ``sum(a[s+1 .. t])`` at ``[t, s]`` for ``s <= t``
    (summed directly, not as a difference of cumulative sums), ``-inf``
    above the diagonal."""
    steps = torch.arange(a.shape[-1], device=a.device)
    x = a[..., :, None].expand(*a.shape, a.shape[-1])  # a_t at [t, s]
    x = x.masked_fill(steps[:, None] <= steps[None, :], 0.0)
    return torch.cumsum(x, dim=-2).masked_fill(steps[:, None] < steps[None, :], -math.inf)


def ssd(x, dt, A, B, C, D, h0, done, seg, chunk: int):
    """The chunked SSD of a Mamba-2 layer over time-major rows with resets.

    ``x [T, b, H, P]``, ``dt [T, b, H]``, ``A`` and ``D [H]``, ``B`` and
    ``C [T, b, N]``, the start state ``h0 [b, H, P, N]``, ``done [T, b]``
    and its :func:`segments` ``seg``. Within each chunk of ``chunk``
    steps, ``y_t = sum_s C_t.B_s exp(sum(dt A)[s+1..t]) dt_s x_s`` over the
    steps ``s <= t`` of t's episode, plus the chunk's start state decayed
    into the steps of its first episode, plus ``D x``; the state after the
    chunk, reset where its last step is done, starts the next. Returns
    ``(y [T, b, H, P], the state after the last step, reset where done)``."""
    T = x.shape[0]
    a = dt * A  # [T, b, H]
    h = h0
    ys = []
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        a_c = a[t0:t1].permute(1, 2, 0)  # [b, H, L]
        dt_c = dt[t0:t1].permute(1, 2, 0)
        x_c = x[t0:t1].permute(1, 2, 0, 3)  # [b, H, L, P]
        B_c = B[t0:t1].transpose(0, 1)  # [b, L, N]
        C_c = C[t0:t1].transpose(0, 1)
        seg_c = seg[t0:t1].T  # [b, L]
        same = seg_c[:, :, None] == seg_c[:, None, :]  # [b, L(t), L(s)]
        decay = torch.exp(_segsum(a_c).masked_fill(~same[:, None], -math.inf))
        scores = decay * (C_c @ B_c.transpose(1, 2))[:, None] * dt_c[:, :, None, :]
        y = scores @ x_c  # [b, H, L, P]
        # The start state, into the steps before the chunk's first done.
        first = (seg_c == seg_c[:, :1])[:, None]  # [b, 1, L]
        into = torch.exp(torch.cumsum(a_c, -1)).masked_fill(~first, 0.0)  # [b, H, L]
        y = y + into[..., None] * (h @ C_c.transpose(1, 2)[:, None]).transpose(-1, -2)
        ys.append(y)
        # The state after the chunk's last step.
        weight = decay[:, :, -1, :] * dt_c  # [b, H, L(s)]
        h = into[:, :, -1, None, None] * h + (weight[..., None] * x_c).transpose(-1, -2) @ B_c[:, None]
        h = torch.where(done[t1 - 1][:, None, None, None], 0.0, h)
    y = torch.cat(ys, dim=2).permute(2, 0, 1, 3)  # [T, b, H, P]
    return y + D[:, None] * x, h


class Mamba2Mixer(StatefulModule):
    """A Mamba-2 layer with one group of ``B`` and ``C``: ``in_proj`` to
    ``[z, xBC, dt]``, a causal depthwise convolution of ``K`` taps with
    bias over ``xBC`` and SiLU, ``x`` in ``H`` heads of ``P``, ``dt =
    softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the state update of
    :func:`~nnx_ppo_tpu_torch.ops.ssm_step.ssm_step_plain`, the gated
    RMSNorm ``norm(y silu(z))`` and ``out_proj``. ``conv_weight`` is ``[K,
    C]``, tap ``K - 1`` on the newest input. ``chunk_size`` is the SSD's
    chunk in the replay (``min(T, chunk_size)`` steps)."""

    def __init__(self, in_proj: Dense, conv_weight, conv_bias, dt_bias, A_log, D, norm: RMSNorm,
                 out_proj: Dense, head_dim: int, d_state: int, chunk_size: int):
        super().__init__()
        self.in_proj, self.norm, self.out_proj = in_proj, norm, out_proj
        self.conv_weight = nn.Parameter(conv_weight)
        self.conv_bias = nn.Parameter(conv_bias)
        self.dt_bias = nn.Parameter(dt_bias)
        self.A_log = nn.Parameter(A_log)
        self.D = nn.Parameter(D)
        self.head_dim, self.d_state, self.chunk_size = head_dim, d_state, chunk_size

    @classmethod
    def create(cls, hidden: int, generator: torch.Generator, *, n_heads: int, head_dim: int,
               d_state: int, d_conv: int = 4, chunk_size: int = 256, eps: float = 1e-5,
               compute_dtype: DType = None) -> "Mamba2Mixer":
        """The initialization of the ``transformers`` library's Granite
        4.0-H Mamba layer: ``A_log = log(1..H)``, ``dt_bias`` and ``D``
        ones, the norm's weight ones, and the convolution as
        ``nn.Conv1d``'s (uniform in ``+-1 / sqrt(K)``). It is not the one
        of Mamba-2's own code (``A`` uniform in ``[1, 16]``, ``dt``
        log-uniform in ``[1e-3, 0.1]`` through ``dt_bias``)."""
        inner = n_heads * head_dim
        channels = inner + 2 * d_state
        bound = 1.0 / math.sqrt(d_conv)

        def uniform(*shape):
            return (2.0 * torch.rand(shape, generator=generator) - 1.0) * bound

        return cls(
            Dense.create(hidden, inner + channels + n_heads, generator, use_bias=False,
                         compute_dtype=compute_dtype),
            uniform(d_conv, channels), uniform(channels), torch.ones(n_heads),
            torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32)), torch.ones(n_heads),
            RMSNorm.create(inner, eps),
            Dense.create(inner, hidden, generator, use_bias=False, compute_dtype=compute_dtype),
            head_dim, d_state, chunk_size,
        )

    @property
    def n_heads(self) -> int:
        return self.A_log.shape[0]

    @property
    def inner(self) -> int:
        return self.n_heads * self.head_dim

    def initialize_state(self, batch_size: int):
        device = self.A_log.device
        K, C = self.conv_weight.shape
        return (torch.zeros((batch_size, self.n_heads, self.head_dim, self.d_state), device=device),
                torch.zeros((batch_size, K - 1, C), device=device))

    def reset_state(self, prev_state):
        return tuple(torch.zeros_like(x) for x in prev_state)

    def _split(self, x: torch.Tensor):
        """``z``, ``xBC``, ``dt`` of ``in_proj(x)``."""
        C = self.conv_weight.shape[1]
        return torch.split(_project(self.in_proj, x), [self.inner, C, self.n_heads], dim=-1)

    def _conv(self, taps: Sequence[torch.Tensor]) -> torch.Tensor:
        """SiLU of the convolution of ``taps`` (oldest first), in one order
        of sums for the step and the replay."""
        out = taps[0] * self.conv_weight[0]
        for k in range(1, len(taps)):
            out = out + taps[k] * self.conv_weight[k]
        return nn.functional.silu(out + self.conv_bias)

    def _ssm_inputs(self, xbc: torch.Tensor, dt: torch.Tensor):
        x, B, C = torch.split(xbc, [self.inner, self.d_state, self.d_state], dim=-1)
        dt = nn.functional.softplus(dt + self.dt_bias)
        return x.unflatten(-1, (self.n_heads, self.head_dim)), B, C, dt, -torch.exp(self.A_log)

    def _output(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return _project(self.out_proj, self.norm.normalize(y.flatten(-2), gate=z))

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        with span("net.mamba"):
            ssm, conv = state
            z, xbc, dt = self._split(x)
            window = torch.cat([conv, xbc[:, None]], dim=1)  # [B, K, C]
            xs, B, C, dt, A = self._ssm_inputs(
                self._conv([window[:, k] for k in range(window.shape[1])]), dt)
            new_ssm, y = ssm_step(ssm, xs, dt, A, B, C, self.D)
            out = self._output(y, z)
        return ModuleOutput((new_ssm, window[:, 1:]), out, 0.0, {}, None)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        with span("net.mamba"):
            ssm0, conv0 = state
            T, b = done_seq.shape
            K = self.conv_weight.shape[0]
            seg = segments(done_seq)
            z, xbc, dt = self._split(obs_seq)
            padded = torch.cat([conv0.transpose(0, 1), xbc], dim=0)  # [K - 1 + T, b, C]
            seg_padded = torch.cat([seg.new_zeros(K - 1, b), seg], dim=0)
            taps = [torch.where((seg_padded[k:k + T] == seg)[..., None], padded[k:k + T], 0.0)
                    for k in range(K)]
            xs, B, C, dt, A = self._ssm_inputs(self._conv(taps), dt)
            y, ssm = ssd(xs, dt, A, B, C, self.D, ssm0, done_seq, seg,
                         min(T, self.chunk_size))
            out = self._output(y, z)
            with torch.no_grad():
                # The last K - 1 inputs of the last episode, zero where done.
                tail = padded[T:].detach()
                keep = (seg_padded[T:] == seg[-1]) & ~done_seq[-1]
                conv = torch.where(keep[..., None], tail, 0.0).transpose(0, 1)
        return out, 0.0, (ssm.detach(), conv)


class GroupedQueryAttention(StatefulModule):
    """Causal attention with ``n_heads`` query heads over ``n_kv_heads``
    key and value heads (query head ``i`` reads KV head ``i // (n_heads /
    n_kv_heads)``), scores scaled by ``multiplier``, no positional
    encoding and no bias, over a cache of ``capacity`` positions."""

    def __init__(self, q_proj: Dense, k_proj: Dense, v_proj: Dense, o_proj: Dense, n_heads: int,
                 n_kv_heads: int, capacity: int, multiplier: float):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = q_proj, k_proj, v_proj, o_proj
        self.n_heads, self.n_kv_heads = n_heads, n_kv_heads
        self.head_dim = q_proj.kernel.shape[1] // n_heads
        self.capacity, self.multiplier = capacity, multiplier

    @classmethod
    def create(cls, hidden: int, generator: torch.Generator, *, n_heads: int, n_kv_heads: int,
               capacity: int, multiplier: float,
               compute_dtype: DType = None) -> "GroupedQueryAttention":
        head_dim = hidden // n_heads

        def dense(n_in, n_out):
            return Dense.create(n_in, n_out, generator, use_bias=False,
                                compute_dtype=compute_dtype)

        return cls(dense(hidden, n_heads * head_dim), dense(hidden, n_kv_heads * head_dim),
                   dense(hidden, n_kv_heads * head_dim), dense(n_heads * head_dim, hidden),
                   n_heads, n_kv_heads, capacity, multiplier)

    def initialize_state(self, batch_size: int):
        device = self.q_proj.kernel.device
        shape = (batch_size, self.capacity, self.n_kv_heads, self.head_dim)
        return (torch.zeros(shape, device=device), torch.zeros(shape, device=device),
                torch.zeros(batch_size, dtype=torch.long, device=device))

    def reset_state(self, prev_state):
        return tuple(torch.zeros_like(x) for x in prev_state)

    def _qkv(self, x: torch.Tensor):
        G, D = self.n_kv_heads, self.head_dim
        q = _project(self.q_proj, x).unflatten(-1, (G, self.n_heads // G, D))
        return q, _project(self.k_proj, x).unflatten(-1, (G, D)), \
            _project(self.v_proj, x).unflatten(-1, (G, D))

    def _attend(self, scores: torch.Tensor, valid: torch.Tensor, values: torch.Tensor, spec: str):
        scores = (scores * self.multiplier).masked_fill(~valid, -math.inf)
        return torch.einsum(spec, torch.softmax(scores, dim=-1), values)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        with span("net.attention"):
            k_cache, v_cache, length = state
            q, k, v = self._qkv(x)  # [B, G, R, D], [B, G, D]
            slot = length.view(-1, 1, 1, 1).expand(-1, 1, *k.shape[1:])
            k_cache = k_cache.scatter(1, slot, k[:, None])
            v_cache = v_cache.scatter(1, slot, v[:, None])
            length = length + 1
            valid = torch.arange(self.capacity, device=x.device) < length[:, None]  # [B, cap]
            o = self._attend(torch.einsum("bgrd,bjgd->bgrj", q, k_cache), valid[:, None, None],
                             v_cache, "bgrj,bjgd->bgrd")
            out = _project(self.o_proj, o.flatten(-3))
        return ModuleOutput((k_cache, v_cache, length), out, 0.0,
                            {"counters": {"attention_cache_length": length}}, None)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        with span("net.attention"):
            k_cache, v_cache, length = state
            T, b = done_seq.shape
            cap = self.capacity
            q, k, v = self._qkv(obs_seq)  # [T, b, G, R, D], [T, b, G, D]
            seg = segments(done_seq).T  # [b, T]
            steps = torch.arange(T, device=obs_seq.device)
            in_cache = ((torch.arange(cap, device=obs_seq.device) < length[:, None])[:, None, :]
                        & (seg == 0)[:, :, None])  # [b, T, cap]
            in_row = (steps[:, None] >= steps[None, :]) & (seg[:, :, None] == seg[:, None, :])
            valid = torch.cat([in_cache, in_row], dim=-1)[:, None, None]  # [b, 1, 1, T, cap + T]
            keys = torch.cat([k_cache, k.transpose(0, 1)], dim=1)  # [b, cap + T, G, D]
            values = torch.cat([v_cache, v.transpose(0, 1)], dim=1)
            o = self._attend(torch.einsum("tbgrd,bjgd->bgrtj", q, keys), valid, values,
                             "bgrtj,bjgd->tbgrd")
            out = _project(self.o_proj, o.flatten(-3))
            with torch.no_grad():
                final = self._final_carry(k.detach(), v.detach(), k_cache, v_cache, length,
                                          done_seq, seg)
        return out, 0.0, final

    def _final_carry(self, k, v, k_cache, v_cache, length, done, seg):
        """The cache after a row's last step: the start cache where the row
        held no episode end, with the last episode's steps at their
        positions in it, all zero where the last step is done."""
        T, b = done.shape
        steps = torch.arange(T, device=done.device)
        # Each step's first step of its episode within the row.
        after = torch.where(done, steps[:, None] + 1, 0)
        start = torch.cat([after.new_zeros(1, b), torch.cummax(after, dim=0).values[:-1]]).T
        first = seg[:, -1] == 0  # [b]: the row's last episode began before it
        pos = steps[None, :] - start + torch.where(seg == 0, length[:, None], 0)  # [b, T]
        last = seg == seg[:, -1:]
        # Steps of earlier episodes go to a spare slot past the capacity.
        index = torch.where(last, pos, self.capacity)[..., None, None].expand(-1, -1, *k.shape[2:])
        keep = (first & ~done[-1])[:, None, None, None]
        out = []
        for cache, new in ((k_cache, k), (v_cache, v)):
            base = torch.cat([torch.where(keep, cache, 0.0), cache.new_zeros(b, 1, *cache.shape[2:])],
                             dim=1)
            out.append(torch.where(~done[-1][:, None, None, None],
                                   base.scatter(1, index, new.transpose(0, 1))[:, :-1], 0.0))
        new_length = torch.where(done[-1], 0, torch.where(first, length + T, T - start[:, -1]))
        return out[0], out[1], new_length


class HybridBlock(StatefulModule):
    """``h = x + r mixer(norm(x))``, then ``h + r mlp(norm(h))``."""

    def __init__(self, input_norm: RMSNorm, mixer: StatefulModule, post_norm: RMSNorm,
                 mlp: SwiGLU, residual_multiplier: float):
        super().__init__()
        self.input_norm, self.mixer, self.post_norm, self.mlp = input_norm, mixer, post_norm, mlp
        self.residual_multiplier = residual_multiplier

    def initialize_state(self, batch_size: int):
        return self.mixer.initialize_state(batch_size)

    def reset_state(self, prev_state):
        return self.mixer.reset_state(prev_state)

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        return h + self.residual_multiplier * self.mlp.mlp(self.post_norm.normalize(h))

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        out = self.mixer(state, self.input_norm.normalize(x))
        h = self._mlp(x + self.residual_multiplier * out.output)
        return ModuleOutput(out.next_state, h, 0.0, out.metrics, None)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        y, _, final = self.mixer.replay_sequence(state, self.input_norm.normalize(obs_seq),
                                                 done_seq, None)
        return self._mlp(obs_seq + self.residual_multiplier * y), 0.0, final


class _StepGraphs(dict):
    """Captured step graphs by input; a copy of the module starts with none."""

    def __deepcopy__(self, memo):
        return _StepGraphs()


class HybridTrunk(StatefulModule):
    """``final_norm(blocks(embedding_multiplier x))``. Carry: one entry
    per block. Its step on a card without gradients is a CUDA graph's
    replay (see the module's docstring)."""

    def __init__(self, blocks: Sequence[HybridBlock], final_norm: RMSNorm,
                 embedding_multiplier: float):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.embedding_multiplier = embedding_multiplier
        self._graphs = _StepGraphs()

    @classmethod
    def create(cls, hidden: int, layer_types: Sequence[str], generator: torch.Generator, *,
               intermediate: int, mamba: dict, attention: dict, residual_multiplier: float,
               embedding_multiplier: float, eps: float = 1e-5,
               compute_dtype: DType = None) -> "HybridTrunk":
        """``layer_types`` of ``"mamba"`` and ``"attention"``; ``mamba`` and
        ``attention`` are the keyword arguments of
        :meth:`Mamba2Mixer.create` and :meth:`GroupedQueryAttention.create`
        but the hidden size, generator and compute dtype."""
        blocks = []
        for kind in layer_types:
            if kind == "mamba":
                mixer = Mamba2Mixer.create(hidden, generator, eps=eps, compute_dtype=compute_dtype,
                                           **mamba)
            elif kind == "attention":
                mixer = GroupedQueryAttention.create(hidden, generator,
                                                     compute_dtype=compute_dtype, **attention)
            else:
                raise ValueError(f"unknown layer type {kind!r}; expected 'mamba' or 'attention'")
            blocks.append(HybridBlock(
                RMSNorm.create(hidden, eps), mixer, RMSNorm.create(hidden, eps),
                SwiGLU.create(hidden, intermediate, generator, compute_dtype), residual_multiplier))
        return cls(blocks, RMSNorm.create(hidden, eps), embedding_multiplier)

    def initialize_state(self, batch_size: int):
        return tuple(block.initialize_state(batch_size) for block in self.blocks)

    def reset_state(self, prev_state):
        return tuple(block.reset_state(s) for block, s in zip(self.blocks, prev_state))

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        if x.is_cuda and not torch.is_grad_enabled():
            return self._graphed_step(state, x)
        return self._step(state, x)

    def _graphed_step(self, state, x: torch.Tensor) -> ModuleOutput:
        """:meth:`_step` by replaying its graph for ``x``'s shape, captured
        on first use and again where a parameter's storage has changed;
        the inputs are copied into the graph's own, and the output and
        counters out of it."""
        key = (tuple(x.shape), x.dtype, x.device)
        storage = tuple(p.data_ptr() for p in self.parameters())
        if key not in self._graphs or self._graphs[key][0] != storage:
            self._graphs.pop(key, None)
            self._graphs[key] = (storage, *self._capture(state, x))
        _, static_state, static_x, graph, out = self._graphs[key]
        for dst, src in zip(tree_leaves(static_state), tree_leaves(state)):
            dst.copy_(src)
        static_x.copy_(x)
        graph.replay()
        mamba = sum(isinstance(block.mixer, Mamba2Mixer) for block in self.blocks)
        cuda_build.count_launch(ssm_step_cuda, x.device, mamba)
        return ModuleOutput(out.next_state, out.output.clone(), 0.0,
                            tree_map(torch.clone, out.metrics), None)

    def _capture(self, state, x: torch.Tensor) -> tuple:
        static_state, static_x = tree_map(torch.clone, state), x.clone()
        stream = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            # Once outside the capture: libraries' and kernels' first-use set-up.
            self._step(static_state, static_x)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._step(static_state, static_x)
        return static_state, static_x, graph, out

    def _step(self, state, x: torch.Tensor) -> ModuleOutput:
        h = x * self.embedding_multiplier
        new_state, counters = [], {}
        for block, s in zip(self.blocks, state):
            out = block(s, h)
            h = out.output
            new_state.append(out.next_state)
            # Every attention layer holds the same positions.
            counters.update(out.metrics.get("counters", {}))
        metrics = {"counters": counters} if counters else {}
        return ModuleOutput(tuple(new_state), self.final_norm.normalize(h), 0.0, metrics, None)

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        h = obs_seq * self.embedding_multiplier
        finals = []
        for block, s in zip(self.blocks, state):
            h, _, final = block.replay_sequence(s, h, done_seq, None)
            finals.append(final)
        return self.final_norm.normalize(h), 0.0, tuple(finals)
