"""Network FLOPs of one ``ppo_step`` of the ``granite_h_micro``
configuration, from its widths, counted as ``counts/networks.py`` counts
an MLP's: ``2 in out`` per sample for every projection (the observation
projection; each Mamba layer's ``in_proj`` and ``out_proj``; the
attention layer's query, key, value and output projections; each layer's
SwiGLU ``input`` and ``output``; the two heads), the whole network forward
once over the rollout's ``n_envs T`` samples and forward and backward
(three forwards) in each of ``n_epochs`` epochs. The SSD's, the
convolution's and attention's own products and the bootstrap value are
left out (about 3% of the step), so the count is a floor of the work
done."""

from __future__ import annotations


def projections(cfg: dict) -> list:
    """``(in, out)`` of every projection of the network."""
    D, F = cfg["hidden_size"], cfg["shared_intermediate_size"]
    H, P, N = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    inner = H * P
    channels = inner + 2 * cfg["mamba_n_groups"] * N
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    head_dim = D // heads
    out = [(cfg["env"]["obs"], D), (D, 2 * cfg["env"]["n_act"]), (D, 1)]
    for kind in cfg["layer_types"]:
        if kind == "mamba":
            out += [(D, inner + channels + H), (inner, D)]
        else:
            out += [(D, heads * head_dim), (D, kv * head_dim), (D, kv * head_dim),
                    (heads * head_dim, D)]
        out += [(D, 2 * F), (F, D)]
    return out


def forward_flops_per_sample(cfg: dict) -> int:
    return sum(2 * a * b for a, b in projections(cfg))


def flops_per_step(cfg: dict, traffic: dict) -> float:
    samples = traffic["n_envs"] * traffic["rollout_length"]
    return forward_flops_per_sample(cfg) * samples * (1 + 3 * traffic["n_epochs"])
