"""The hybrid trunk of Mamba-2 and attention layers (``networks/hybrid.py``)
and its state-space step (``ops/ssm_step.py``, ``csrc/ssm_step.cu``) on the
CPU, at tiny widths, against the benchmark's plain reference of the
``granite_h_micro`` configuration (``portbench/reference/granite_h_micro.py``:
the Mamba-2 recurrence one step at a time, attention over the episode's
cached positions).

* The step form (the rollout's), the chunked replay (chunk 4 over 10
  steps, episode ends at a chunk's first, middle and last step and twice
  in one chunk) and the reference's replay agree, for a trunk of Mamba
  layers, of an attention layer, and of both.
* The trunk's loss and gradients through ``ppo_loss`` equal the
  reference's, and it trains through ``ppo_step`` with the time-major
  replay, its counters in the step's metrics, its stored start carry
  untouched.
* Planted faults each fail: a reset ignored inside a chunk, a key/value
  cache not cleared at ``done``, the convolution's state carried across
  ``done``, the residual multiplier dropped.
* The CUDA kernel, compiled for the host against ``tests/cuda_host_stub.h``
  (as ``test_torch_kernel_schedule.py`` does), equals the plain step.
* On a card (skipped without one): the trunk's rollout step, a CUDA
  graph's replay, takes its own returned carry back as ``eval_rollout``
  passes it on, counts one SSM kernel launch per Mamba layer and replay
  (none while capturing), is captured anew for a replaced parameter, and
  ``eval_rollout`` through it equals ``eval_rollout`` through the eager
  step to the bit.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nnx_ppo_tpu_torch.algorithms import ppo
from nnx_ppo_tpu_torch.algorithms.ppo import ReplayMinibatch, ppo_loss
from nnx_ppo_tpu_torch.algorithms.types import LoggingLevel
from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_map, tree_where
from nnx_ppo_tpu_torch.networks import GroupedQueryAttention, HybridBlock, Mamba2Mixer, hybrid
from nnx_ppo_tpu_torch.ops.cuda_build import CSRC_DIR
from nnx_ppo_tpu_torch.ops.ssm_step import ssm_step, ssm_step_cuda, ssm_step_plain

from portbench import program
from portbench.configs import granite_h_micro as config_module
from portbench.reference import granite_h_micro as reference
from portbench.reference import ppo as ref_ppo

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "granite_h_micro.json").read_text())
# Hidden 32, 4 Mamba heads of 8 and d_state 16 (expand 1), 4 query heads
# over 2 KV heads of 8, chunk 4 over T 10; an episode limit of 12 under a
# cache of 32, so that a cache that is not cleared still fits.
TINY = {"hidden_size": 32, "mamba_n_heads": 4, "mamba_d_head": 8, "mamba_expand": 1,
        "mamba_d_state": 16, "mamba_chunk_size": 4, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 48, "shared_intermediate_size": 48}
T, B = 10, 8
# Episode ends (after the step) per row: none; a chunk's first step; its
# middle; its last step and the next chunk's last; twice in one chunk; the
# row's last step; the row's first step; at 2 and 5.
DONE = [[], [4], [1], [3, 7], [4, 6], [9], [0], [2, 5]]
LAYERS = {"mamba": ["mamba", "mamba"], "attention": ["attention"],
          "both": ["mamba", "attention", "mamba"]}
STD = {"reward_keys": ["reward"]}
# Step form against replay: one float32 function in two orders of sums.
SAME_FUNCTION = dict(rtol=2e-5, atol=2e-6)
# Program against reference: the chunked SSD's segment sums of dt A and
# the masked attention against a step-by-step recurrence and cache.
AGAINST_REFERENCE = dict(rtol=1e-4, atol=2e-5)


def tiny_config(layer_types) -> dict:
    cfg = dict(CONFIG, **TINY, layer_types=list(layer_types), num_hidden_layers=len(layer_types))
    cfg["env"] = dict(cfg["env"], episode_length=12)
    cfg["network"] = dict(cfg["network"], kv_cache_capacity=32)
    return cfg


def tiny_model(layer_types, seed=7, **widths):
    """``(cfg, port network, weights, reference net)`` with the
    benchmark's weights of ``seed`` in both; ``widths`` replace
    :data:`TINY`'s."""
    cfg = dict(tiny_config(layer_types), **widths)
    built = config_module.build(cfg, {"n_envs": B, "rollout_length": T, "n_epochs": 2,
                                      "n_minibatches": 2})
    weights = program.make_weights(reference.parameters(cfg), seed, torch.device("cpu"))
    net = built["networks"]
    named = dict(net.named_parameters())
    assert set(named) == set(built["port_names"].values())
    with torch.no_grad():
        for ref_name, port_name in built["port_names"].items():
            named[port_name].copy_(weights[ref_name])
    return cfg, net, weights, reference.Net(cfg, cfg["compute_dtype"])


def done_mask() -> torch.Tensor:
    done = torch.zeros(T, B, dtype=torch.bool)
    for row, steps in enumerate(DONE):
        done[steps, row] = True
    return done


def port_extras(obs, raw, noise):
    return (obs, None, None, {"action": (None, {"raw_action": raw, "entropy_noise": noise}),
                              "value": None})


def inputs(seed=3):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn(T, B, 5, generator=g)
    raw = torch.randn(T, B, 1, generator=g)
    noise = torch.randn(T, B, 1, generator=g)
    return obs, raw, noise


def start_carry(net, seed=5):
    """A carry some steps into an episode: the step form from zeros on
    random observations."""
    g = torch.Generator().manual_seed(seed)
    state = net.initialize_state(B)
    with torch.no_grad():
        for _ in range(3):
            state = net(state, torch.randn(B, 5, generator=g), None, g).next_state
    return state


def port_steps(net, state, obs, raw, noise, done):
    """The step form over ``T`` steps, reset where done: loglik and value
    ``[T, B]`` and the final carry."""
    ll, values = [], []
    for t in range(T):
        out = net(state, obs[t], port_extras(obs[t], raw[t], noise[t]))
        ll.append(out.output.loglikelihoods)
        values.append(out.output.value_estimates)
        state = tree_where(done[t], net.reset_state(out.next_state), out.next_state)
    return torch.stack(ll), torch.stack(values), state


def reference_replay(cfg, ref, weights, state, obs, raw, noise, done):
    stats = reference.initial_stats(cfg, torch.device("cpu"))
    ll, values, _, final = ref.replay(weights, stats, obs.transpose(0, 1),
                                      (raw.transpose(0, 1), noise.transpose(0, 1)),
                                      config_module.carry_state(state), done.T)
    return ll.T, values["reward"].T, final


def assert_carries(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **tol, msg=k)


def replay_three_ways(layer_types):
    cfg, net, weights, ref = tiny_model(layer_types)
    obs, raw, noise = inputs()
    done = done_mask()
    state = start_carry(net)
    with torch.no_grad():
        out, _, final = net.replay_sequence(state, obs, done, port_extras(obs, raw, noise))
        steps = port_steps(net, state, obs, raw, noise, done)
        refs = reference_replay(cfg, ref, weights, state, obs, raw, noise, done)
    replayed = (out.loglikelihoods, out.value_estimates, final)
    return replayed, steps, refs


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_step_form_chunked_replay_and_reference_agree(kind):
    (ll, v, final), (ll_s, v_s, final_s), (ll_r, v_r, final_r) = replay_three_ways(LAYERS[kind])
    torch.testing.assert_close(ll, ll_s, **SAME_FUNCTION)
    torch.testing.assert_close(v, v_s, **SAME_FUNCTION)
    assert_carries(config_module.carry_state(final), config_module.carry_state(final_s),
                   **SAME_FUNCTION)
    torch.testing.assert_close(ll, ll_r, **AGAINST_REFERENCE)
    torch.testing.assert_close(v, v_r, **AGAINST_REFERENCE)
    assert_carries(config_module.carry_state(final), final_r, **AGAINST_REFERENCE)
    # The episode ends reset the carry: the rows done at their last step
    # end at zero, and the cache's length counts the last episode's steps.
    carry = config_module.carry_state(final)
    assert all(float(x[5].abs().max()) == 0.0 for x in carry.values())
    if kind != "mamba":
        # Three steps before the row (start_carry), then the row's.
        length = next(x for k, x in carry.items() if k.endswith("length"))
        assert length[0] == 3 + T and length[3] == 2 and length[6] == 9


def _minibatch(net, state, obs, raw, noise, done):
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        old = port_steps(net, state, obs, raw, noise, done)[0] + 0.01 * torch.randn(T, B,
                                                                                    generator=g)
    rewards = torch.rand(T, B, generator=g)
    truncated = torch.zeros(T, B, dtype=torch.bool)
    last = torch.randn(B, 5, generator=g)
    return old, rewards, truncated, last


def test_loss_and_gradients_equal_the_references():
    cfg, net, weights, ref = tiny_model(LAYERS["both"])
    obs, raw, noise = inputs()
    done = done_mask()
    state = start_carry(net)
    old, rewards, truncated, last = _minibatch(net, state, obs, raw, noise, done)
    p = cfg["ppo"]
    view = ReplayMinibatch(obs=obs, old_loglikelihoods=old, rewards=rewards, done=done,
                           truncated=truncated, rollout_extras=port_extras(obs, raw, noise),
                           last_next_obs=last)
    loss, metrics = ppo_loss(net, state, view, clip_range=p["clip_range"],
                             normalize_advantages=p["normalize_advantages"],
                             combine_advantages=p["combine_advantages"],
                             discounting_factor=p["discounting_factor"],
                             gae_lambda=p["gae_lambda"], critic_loss_weight=p["critic_loss_weight"],
                             logging_level=LoggingLevel.LOSSES)
    loss.backward()
    assert float(metrics["counters/episode_boundaries"]) == float(done[:-1].sum())
    mb = {"obs": obs.transpose(0, 1), "extras": (raw.transpose(0, 1), noise.transpose(0, 1)),
          "loglik": old.T, "rewards": {"reward": rewards.T}, "done": done.T,
          "truncated": truncated.T, "carry": config_module.carry_state(state),
          "last_next_obs": last}
    leaves = {k: w.clone().requires_grad_(True) for k, w in weights.items()}
    stats = reference.initial_stats(cfg, torch.device("cpu"))
    ref_loss = ref_ppo.minibatch_loss(ref, leaves, stats, mb, dict(p, **STD))
    grads = dict(zip(leaves, torch.autograd.grad(ref_loss, list(leaves.values()))))
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0.0)
    port_names = config_module.build(cfg, {"n_envs": B, "rollout_length": T, "n_epochs": 2,
                                           "n_minibatches": 2})["port_names"]
    named = dict(net.named_parameters())
    scale = max(float(g.abs().max()) for g in grads.values())
    for ref_name, port_name in port_names.items():
        torch.testing.assert_close(named[port_name].grad, grads[ref_name], rtol=1e-3,
                                   atol=1e-5 * scale, msg=ref_name)


def test_the_hybrid_trains_through_ppo_step():
    from nnx_ppo_tpu_torch.algorithms import make_optimizer, new_training_state, ppo_step

    cfg = tiny_config(LAYERS["both"])
    traffic = {"n_envs": B, "rollout_length": T, "n_epochs": 2, "n_minibatches": 2}
    built = config_module.build(cfg, traffic)
    config = built["config"]
    assert not ppo.resolve_batch_major(config, built["networks"])
    opt = make_optimizer(config.learning_rate)
    ts = new_training_state(built["env"], built["networks"], B, 3, optimizer=opt, device="cpu")
    for _ in range(3):
        before = tree_map(torch.clone, ts.network_states)
        kept = ts.network_states
        ts, metrics = ppo_step(built["env"], ts, config, opt)
        # The stored start carry is never written in place.
        for a, b in zip(torch.utils._pytree.tree_leaves(kept),
                        torch.utils._pytree.tree_leaves(before)):
            assert torch.equal(a, b)
    assert torch.isfinite(metrics["losses/actor/mean"])
    length = config_module.carry_state(ts.network_states)["layers.1.length"]
    assert torch.equal(metrics["counters/attention_cache_length"],
                       length.float().mean()) or bool((length == 0).any())
    assert 0.0 < float(metrics["counters/attention_cache_length"]) <= 12.0
    assert float(metrics["counters/episode_boundaries/mean"]) >= 0.0


# -- planted faults ------------------------------------------------------------------


def _reset_ignored_inside_a_chunk(monkeypatch):
    ssd = hybrid.ssd

    def no_segments(x, dt, A, B_, C, D, h0, done, seg, chunk):
        return ssd(x, dt, A, B_, C, D, h0, done, torch.zeros_like(seg), chunk)

    monkeypatch.setattr(hybrid, "ssd", no_segments)


def _cache_not_cleared(monkeypatch):
    monkeypatch.setattr(GroupedQueryAttention, "reset_state", lambda self, prev: prev)


def _conv_carried_across_done(monkeypatch):
    monkeypatch.setattr(Mamba2Mixer, "reset_state",
                        lambda self, prev: (torch.zeros_like(prev[0]), prev[1]))


def _residual_dropped(monkeypatch):
    init = HybridBlock.__init__

    def unscaled(self, *args):
        init(self, *args)
        self.residual_multiplier = 1.0

    monkeypatch.setattr(HybridBlock, "__init__", unscaled)


FAULTS = {"reset_ignored_inside_a_chunk": (_reset_ignored_inside_a_chunk, "mamba", "replay"),
          "cache_not_cleared_at_done": (_cache_not_cleared, "attention", "steps"),
          "conv_state_carried_across_done": (_conv_carried_across_done, "mamba", "steps"),
          "residual_multiplier_dropped": (_residual_dropped, "both", "replay")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails_against_the_reference(monkeypatch, fault):
    plant, kind, form = FAULTS[fault]
    plant(monkeypatch)
    replayed, steps, refs = replay_three_ways(LAYERS[kind])
    got = replayed if form == "replay" else steps
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got[0], refs[0], **AGAINST_REFERENCE)
        torch.testing.assert_close(got[1], refs[1], **AGAINST_REFERENCE)


# -- the state-space step --------------------------------------------------------------


def step_inputs(E, H=2, P=8, N=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(E, H, P, N, generator=g), torch.randn(E, H, P, generator=g),
            torch.rand(E, H, generator=g) + 0.1, -torch.rand(H, generator=g) - 0.5,
            torch.randn(E, N, generator=g), torch.randn(E, N, generator=g),
            torch.randn(H, generator=g))


def test_the_trunk_graphs_its_step_only_on_a_card_and_a_copy_holds_none():
    """The trunk's step is a CUDA graph's replay only on a card without
    gradients (``portbench/tests/test_portbench_granite.py`` holds it to
    the eager step there): on the CPU it is the eager step and captures
    nothing, and a copy of the trunk (as ``new_training_state`` makes)
    starts with no graph."""
    import copy

    _, net, _, _ = tiny_model(LAYERS["both"])
    trunk = net.layers[2]
    x = torch.randn(B, TINY["hidden_size"], generator=torch.Generator().manual_seed(1))
    state = trunk.initialize_state(B)
    with torch.no_grad():
        a, b = trunk(state, x), trunk._step(state, x)
    assert torch.equal(a.output, b.output) and not trunk._graphs
    assert all(torch.equal(p, q) for p, q in zip(tree_leaves(a.next_state),
                                                  tree_leaves(b.next_state)))
    trunk._graphs["shape"] = object()
    assert not copy.deepcopy(trunk)._graphs


def test_the_plain_step_is_the_recurrence_and_the_kernel_takes_only_cuda():
    state, x, dt, A, Bm, Cm, D = step_inputs(3)
    new, y = ssm_step(state, x, dt, A, Bm, Cm, D)
    for e in range(3):
        for h in range(2):
            s = torch.exp(dt[e, h] * A[h]) * state[e, h] + torch.outer(dt[e, h] * x[e, h], Bm[e])
            torch.testing.assert_close(new[e, h], s)
            torch.testing.assert_close(y[e, h], s @ Cm[e] + D[h] * x[e, h])
    with pytest.raises(ValueError, match="CUDA"):
        ssm_step_cuda(state, x, dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="expected"):
        ssm_step_cuda(state, x[:, :1], dt, A, Bm, Cm, D)


HOST_MAIN = r"""
#include "cuda_runtime.h"
#include "kernel.cu"

#include <string>

// dir E H P N: reads state.bin x.bin dt.bin A.bin B.bin C.bin D.bin,
// writes new.bin y.bin.
int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const std::string dir = argv[1];
  const int E = std::atoi(argv[2]), H = std::atoi(argv[3]), P = std::atoi(argv[4]),
            N = std::atoi(argv[5]);
  const char* names[] = {"state", "x", "dt", "A", "B", "C", "D"};
  std::vector<std::vector<char>> in;
  for (const char* name : names) in.push_back(stub_read((dir + "/" + name + ".bin").c_str()));
  std::vector<float> out(static_cast<size_t>(E) * H * P * N), y(static_cast<size_t>(E) * H * P);
  const float* p[7];
  for (int k = 0; k < 7; ++k) p[k] = reinterpret_cast<const float*>(in[k].data());
  const int err = ssm_step_forward(p[0], p[1], p[2], p[3], p[4], p[5], p[6], out.data(),
                                   y.data(), E, H, P, N, 0, nullptr);
  stub_write((dir + "/new.bin").c_str(), out.data(), out.size() * 4);
  stub_write((dir + "/y.bin").c_str(), y.data(), y.size() * 4);
  return err;
}
"""


def test_the_kernel_on_the_host_matches_the_plain_step(tmp_path):
    """Three envs, two heads of 8, d_state 64 (two warps a block): the new
    state to float32 rounding of the same products (glibc's ``expf``
    against PyTorch's CPU ``exp``), ``y`` summed in another order."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: no host rehearsal of the CUDA kernel")
    text = (CSRC_DIR / "ssm_step.cu").read_text()
    text = re.sub(r"(\w+)<<<(.*?)>>>\(", r"stub_launch(\1, \2, ", text, flags=re.S)
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(stub_shared_memory());", text)
    shutil.copy(ROOT / "tests" / "cuda_host_stub.h", tmp_path / "cuda_runtime.h")
    (tmp_path / "kernel.cu").write_text(text)
    (tmp_path / "main.cpp").write_text(HOST_MAIN)
    built = subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-pthread", "-w",
                            f"-I{tmp_path}", "-o", str(tmp_path / "kernel"),
                            str(tmp_path / "main.cpp")], capture_output=True, text=True,
                           timeout=240)
    assert built.returncode == 0, built.stdout + built.stderr
    args = step_inputs(3)
    for name, t in zip(("state", "x", "dt", "A", "B", "C", "D"), args):
        t.numpy().astype(np.float32).tofile(tmp_path / f"{name}.bin")
    done = subprocess.run([str(tmp_path / "kernel"), str(tmp_path), "3", "2", "8", "64"],
                          capture_output=True, text=True, timeout=60)
    assert done.returncode == 0, done.stderr
    new = torch.from_numpy(np.fromfile(tmp_path / "new.bin", np.float32).reshape(3, 2, 8, 64))
    y = torch.from_numpy(np.fromfile(tmp_path / "y.bin", np.float32).reshape(3, 2, 8))
    want_new, want_y = ssm_step_plain(*args)
    torch.testing.assert_close(new, want_new, rtol=2e-7, atol=1e-7)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)


# -- on a card -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_model(cuda):
    """The tiny network of both layer kinds on the card, ``d_state`` 32
    (the least the SSM step kernel takes)."""
    cfg, net, _, _ = tiny_model(LAYERS["both"], mamba_d_state=32)
    return cfg, net.to(cuda)


@pytest.mark.gpu
def test_the_graphed_step_takes_its_carry_back_counts_its_launches_and_recaptures(cuda):
    """Control step after control step, the graphed trunk's carry passed
    straight to its next step (as ``eval_rollout`` passes it) gives the
    eager step's output and carry to the bit. A step counts the kernel
    launches that ran: the eager step one per Mamba layer, a replay one
    per Mamba layer, a capture's eager warm-up one per Mamba layer and its
    recording none. A parameter replaced, not updated in place, is
    captured anew in the same entry."""
    _, net = card_model(cuda)
    trunk = net.layers[2]
    n_mamba = sum(isinstance(block.mixer, Mamba2Mixer) for block in trunk.blocks)
    g = torch.Generator(device=cuda).manual_seed(2)
    eager, graphed = trunk.initialize_state(B), trunk.initialize_state(B)
    counted = []
    with torch.no_grad():
        for step in range(4):
            if step == 2:
                mixer = trunk.blocks[0].mixer
                mixer.D = torch.nn.Parameter(mixer.D.detach() * 2.0)
            x = torch.randn(B, TINY["hidden_size"], generator=g, device=cuda)
            before = ssm_step_cuda.launches
            a = trunk._step(eager, x)
            middle = ssm_step_cuda.launches
            b = trunk(graphed, x)
            counted.append((middle - before, ssm_step_cuda.launches - middle))
            assert torch.equal(a.output, b.output)
            for p, q in zip(tree_leaves(a.next_state), tree_leaves(b.next_state), strict=True):
                assert torch.equal(p, q)
            eager, graphed = a.next_state, b.next_state
    assert counted == [(n_mamba, 2 * n_mamba), (n_mamba, n_mamba),
                       (n_mamba, 2 * n_mamba), (n_mamba, n_mamba)]
    assert len(trunk._graphs) == 1


@pytest.mark.gpu
def test_eval_rollout_through_the_graphed_step_equals_the_eager_one(cuda):
    from nnx_ppo_tpu_torch.algorithms.rollout import eval_rollout

    cfg, net = card_model(cuda)
    env = config_module.build(cfg, {"n_envs": B, "rollout_length": T, "n_epochs": 2,
                                    "n_minibatches": 2})["env"]
    trunk = net.layers[2]
    runs = []
    for graphed in (True, False):
        if not graphed:
            trunk.forward = lambda state, x, *_: trunk._step(state, x)
        with torch.no_grad():
            runs.append(eval_rollout(env, net, B, cfg["env"]["episode_length"],
                                     torch.Generator(device=cuda).manual_seed(11)))
    assert len(trunk._graphs) == 1
    assert runs[0].keys() == runs[1].keys()
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
