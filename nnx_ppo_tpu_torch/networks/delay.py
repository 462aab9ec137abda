"""k-step delay layer. Port of ``nnx_ppo_tpu/networks/delay.py:30-208``.

The output at time t is the input from time t - k_steps; before the ring
buffer fills, and after every episode reset, it is ``initial_value``.

Carry::

    {"buffer": <tree mirroring the input, leaves [B, k_steps, *leaf]>,
     "idx":    <[B] int32 circular write pointer>}

The step reads the slot at ``idx`` by index and writes it by a one-hot
select over the (tiny) ring axis. :meth:`Delay.replay_sequence` is the
JAX package's vectorised replay (``delay.py:84-190``): no loop over
time, the output and the final carry built from the input sequence, the
done pattern and the carry it starts from; it equals the step-wise scan
exactly.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from nnx_ppo_tpu_torch.core.struct import tree_map
from nnx_ppo_tpu_torch.networks.types import ModuleOutput, StatefulModule


def _trailing(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """``mask`` with singleton axes appended up to ``ndim`` axes."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


class Delay(StatefulModule):
    """k-step delay over an input tree (a tensor, or a dict / tuple of
    them)."""

    def __init__(self, sample_input: Any, k_steps: int, initial_value: float = 0.0):
        super().__init__()
        if k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self.k_steps = k_steps
        self.initial_value = initial_value
        # Shapes and dtypes of one unbatched input, as zero tensors.
        self.leaf_specs = tree_map(
            lambda x: torch.zeros(tuple(x.shape), dtype=x.dtype), sample_input
        )
        # Carries are made on the module's device.
        self.register_buffer("_anchor", torch.zeros(0), persistent=False)

    @classmethod
    def create(cls, sample_input: Any, k_steps: int, initial_value: float = 0.0) -> "Delay":
        """``sample_input`` is one *unbatched* example of the input tree;
        only its shapes, dtypes and structure are kept."""
        return cls(sample_input, k_steps, initial_value)

    def forward(self, state, x, rollout_extras=None, generator=None) -> ModuleOutput:
        idx = state["idx"]
        batch = torch.arange(idx.shape[0], device=idx.device)
        ring = idx.long()
        onehot = F.one_hot(ring, self.k_steps).bool()  # [B, k]

        def write(b: torch.Tensor, x_: torch.Tensor) -> torch.Tensor:
            return torch.where(_trailing(onehot, b.ndim), x_.unsqueeze(1), b)

        delayed = tree_map(lambda b: b[batch, ring], state["buffer"])
        new_buffer = tree_map(write, state["buffer"], x)
        return ModuleOutput(
            next_state={"buffer": new_buffer, "idx": (idx + 1) % self.k_steps},
            output=delayed,
            regularization_loss=torch.zeros(idx.shape[0], device=idx.device),
            metrics={},
            rollout_extras=None,
        )

    def replay_sequence(self, state, obs_seq, done_seq, extras_seq):
        """Vectorised replay: ``out[t] = x[t-k]`` unless a reset happened
        in steps ``[t-k, t-1]`` (then ``initial_value``), or ``t < k`` in
        the first episode segment (then the slot of the carry's buffer
        that the step-wise scan would read). The final carry is rebuilt
        from the last ``k`` inputs with the same reset masking."""
        del extras_seq
        k, init = self.k_steps, self.initial_value
        T, B = done_seq.shape
        dev = done_seq.device
        idx0 = state["idx"].long()  # [B]
        batch = torch.arange(B, device=dev)

        # prev_cs[t]: dones strictly before step t.
        cs = torch.cumsum(done_seq.long(), dim=0)
        zeros = torch.zeros((1, B), dtype=cs.dtype, device=dev)
        prev_cs = torch.cat([zeros, cs[:-1]], dim=0)
        # Dones in the window [t-k, t-1]; min(k, T) rows of padding keep
        # T < k shape-correct.
        prev_cs_km = torch.cat(
            [zeros.expand(min(k, T), B), prev_cs[: max(T - k, 0)]], dim=0
        )
        window_clear = (prev_cs - prev_cs_km) == 0  # [T, B]
        first_segment = prev_cs == 0
        t_range = torch.arange(T, device=dev)[:, None]  # [T, 1]
        # Carry-buffer reads for t < k in the first segment: slot
        # (idx0 + t) % k.
        slots = (idx0[None, :] + torch.arange(min(k, T), device=dev)[:, None]) % k  # [k', B]
        use_carry = first_segment & (t_range < k)
        use_shift = window_clear & (t_range >= k)

        def per_leaf(x: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
            # x [T, B, *f]; buf [B, k, *f]
            pad = torch.full((min(k, T), *x.shape[1:]), init, dtype=x.dtype, device=dev)
            x_shift = torch.cat([pad, x[: max(T - k, 0)]], dim=0)
            carry_read = buf[batch[None, :], slots].to(x.dtype)  # [k', B, *f]
            pad = torch.full(
                (T - carry_read.shape[0], *carry_read.shape[1:]), init, dtype=x.dtype, device=dev
            )
            carry_read = torch.cat([carry_read, pad], dim=0)  # [T, B, *f]
            out = torch.full_like(x, init)
            out = torch.where(_trailing(use_shift, x.ndim), x_shift, out)
            return torch.where(_trailing(use_carry, x.ndim), carry_read, out)

        out_seq = tree_map(per_leaf, obs_seq, state["buffer"])

        # Final carry: the last reset per env (-1 if none).
        r = torch.where(done_seq.bool(), t_range, -1).max(dim=0).values  # [B]
        any_reset = r >= 0
        idx_T = torch.where(any_reset, (T - 1 - r) % k, (idx0 + T) % k)  # [B]

        def final_leaf(x: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
            new_buf = buf
            for j in range(1, k + 1):
                slot = (idx_T - j) % k  # [B]
                t_w = T - j  # the step that wrote this slot
                if t_w >= 0:
                    written = x[t_w]
                    # It survives only if written strictly after the reset.
                    val = torch.where(
                        _trailing(t_w > r, written.ndim), written, torch.full_like(written, init)
                    )
                else:
                    # Before the window: the carry's own content survives
                    # only if there was no reset at all.
                    carried = buf[batch, (idx0 + t_w) % k].to(x.dtype)
                    val = torch.where(
                        _trailing(~any_reset, carried.ndim), carried, torch.full_like(carried, init)
                    )
                onehot = F.one_hot(slot, k).bool()  # [B, k]
                new_buf = torch.where(_trailing(onehot, new_buf.ndim), val.unsqueeze(1), new_buf)
            return new_buf

        final_buffer = tree_map(final_leaf, obs_seq, state["buffer"])
        final_state = {"buffer": final_buffer, "idx": idx_T.to(torch.int32)}
        return out_seq, torch.zeros((T, B), device=dev), final_state

    def initialize_state(self, batch_size: int) -> dict:
        dev = self._anchor.device
        buffer = tree_map(
            lambda s: torch.full(
                (batch_size, self.k_steps, *s.shape), self.initial_value, dtype=s.dtype, device=dev
            ),
            self.leaf_specs,
        )
        return {"buffer": buffer, "idx": torch.zeros(batch_size, dtype=torch.int32, device=dev)}

    def reset_state(self, prev_state: dict) -> dict:
        return {
            "buffer": tree_map(lambda b: torch.full_like(b, self.initial_value), prev_state["buffer"]),
            "idx": torch.zeros_like(prev_state["idx"]),
        }
