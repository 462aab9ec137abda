"""Network FLOPs of one ``ppo_step``, from a configuration's widths.

Each dense layer costs ``2 in out`` per sample forward (the matrix
product; biases and activations are left out). A step runs the whole
network forward once over the rollout's ``n_envs T`` samples and, in
each of ``n_epochs`` epochs, forward and backward over the same number
(backward: the input's and the kernel's gradients, twice the forward).
The bootstrap value of each minibatch is left out, so the count is a
floor of the work done.
"""

from __future__ import annotations


def layer_sizes(cfg: dict) -> list:
    """``(in, out)`` of every dense layer of the configuration's network."""
    env, net = cfg["env"], cfg["network"]
    n_act = env["n_act"]
    if "encoder" in net:
        layers = [(env["obs"][k], w) for k, w in net["encoder"].items()]
        width = sum(net["encoder"].values())
        heads = len(cfg["reward_keys"])
    else:
        width, layers, heads = env["obs"], [], 1
    actor = [width, *net["actor_hidden"], 2 * n_act]
    critic = [width, *net["critic_hidden"], 1]
    layers += list(zip(actor[:-1], actor[1:]))
    layers += heads * list(zip(critic[:-1], critic[1:]))
    return layers


def forward_flops_per_sample(cfg: dict) -> int:
    return sum(2 * a * b for a, b in layer_sizes(cfg))


def flops_per_step(cfg: dict, traffic: dict) -> float:
    samples = traffic["n_envs"] * traffic["rollout_length"]
    return forward_flops_per_sample(cfg) * samples * (1 + 3 * traffic["n_epochs"])
