"""The cell ``granite_h_micro.e64t128``: a policy whose trunk is one period
of IBM Granite 4.0-H Micro (Mamba-2 and attention layers) and whose carry
is 21.4 MB an env.

On the CPU, at tiny widths and traffic: the cell's check is correct; the
reference with its carry not reset where an episode ends, in the program's
place, is not, nor is the port with its chunked replay ignoring the
episode ends inside a chunk; the stand-ins of ``calibrate_large.py`` read
what ``calibrate.py``'s read. On the card (``-m gpu``), at the cell's own
size: correct on three seeds within four host copies of the parameters
and moments (the copies, the peak host memory and the check's seconds
printed with ``-s``), and the step-form SSM kernel held to its plain
version at 64 envs and at a ragged 33.
"""

from __future__ import annotations

import json
import resource
import time

import pytest
import torch

from portbench import calibrate, calibrate_large, cells, check, run
from portbench.tests.conftest import full_cell

CPU = torch.device("cpu")
NAME = "granite_h_micro.e64t128"
# Hidden 32, 4 Mamba heads of 16 and d_state 16, 4 query heads over 2 KV
# heads, chunk 4 over T 10, three Mamba layers and one attention layer;
# episodes of at most 12 steps, so that each checked step holds episode
# ends, under a cache of 32 positions, so that a carry left unreset fits.
TINY_WIDTHS = {"hidden_size": 32, "mamba_n_heads": 4, "mamba_d_head": 16, "mamba_d_state": 16,
               "mamba_chunk_size": 4, "num_attention_heads": 4, "num_key_value_heads": 2,
               "intermediate_size": 48, "shared_intermediate_size": 48,
               "layer_types": ["mamba", "mamba", "attention", "mamba"], "num_hidden_layers": 4}
TINY_TRAFFIC = dict(n_envs=8, rollout_length=10, n_epochs=2, n_minibatches=2)


def tiny_granite() -> dict:
    cell = full_cell(NAME)
    cfg = dict(cell["config"], **TINY_WIDTHS)
    cfg["env"] = dict(cfg["env"], episode_length=12)
    cfg["network"] = dict(cfg["network"], kv_cache_capacity=32)
    cfg["check"] = dict(cfg["check"], steps=2)
    cell["config"] = cfg
    cell["traffic"] = dict(cell["traffic"], **TINY_TRAFFIC)
    return cell


def test_the_cells_check_is_correct():
    result = run.run_cell(tiny_granite(), 2**31 + 7, 0.5, False, CPU)
    assert result["correct"] is True, result["checked"]
    assert set(result["checked"]) >= {"carry_gap", "stats_gap"}


def test_a_carry_not_reset_is_not_correct():
    cell = tiny_granite()
    reading = calibrate.stand_in_reading(cell, 4243, CPU, "fault", fault="carry_reset")
    assert not check.verdict(reading["gaps"], cell["limits"]), reading["gaps"]
    assert reading["gaps"]["carry_gap"] > cell["limits"]["carry_gap"]


def test_a_reset_ignored_inside_a_chunk_is_not_correct(monkeypatch):
    from nnx_ppo_tpu_torch.networks import hybrid

    ssd = hybrid.ssd

    def no_segments(x, dt, A, B, C, D, h0, done, seg, chunk):
        return ssd(x, dt, A, B, C, D, h0, done, torch.zeros_like(seg), chunk)

    monkeypatch.setattr(hybrid, "ssd", no_segments)
    result = run.run_cell(tiny_granite(), 2**31 + 7, 0.5, False, CPU)
    assert result["correct"] is False, result["checked"]


@pytest.mark.parametrize("kind,args", [("reordered", {"precision": "bfloat16/split"}),
                                       ("fault_carry_reset", {"fault": "carry_reset"})])
def test_the_lean_stand_in_reads_what_the_whole_one_reads(kind, args):
    cell = tiny_granite()
    whole = calibrate.stand_in_reading(cell, 515, CPU, kind, **args)
    lean = calibrate_large.stand_in_reading(cell, 515, CPU, kind, **args)
    assert lean["gaps"] == whole["gaps"]


def test_the_reference_and_its_counts_load_nothing_of_the_port():
    import os
    import subprocess
    import sys

    from portbench.tests.conftest import ROOT

    code = ("import json, sys\n"
            "import portbench.reference.granite_h_micro, portbench.counts.granite_h_micro\n"
            "import portbench.counts.ssm_step, portbench.calibrate_large\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "nnx_ppo_tpu", "nnx_ppo_tpu_torch"}


# -- on the card ------------------------------------------------------------------------


def _exact_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_the_cell_is_correct_on_the_card_within_four_host_copies(cuda_device, monkeypatch):
    from portbench import program

    _exact_float32()
    cell = full_cell(NAME)
    seen, check_s = [], []
    check_steps, compare = program.Program.check_steps, check.compare

    def kept(self, *args):
        seen.append(self)
        return check_steps(self, *args)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = compare(*args, **kwargs)
        check_s.append(time.perf_counter() - t0)
        return out

    monkeypatch.setattr(program.Program, "check_steps", kept)
    monkeypatch.setattr(check, "compare", timed)
    n_params = sum(torch.Size(shape).numel() for _, shape, _ in
                   cells.load_module("reference", "granite_h_micro").parameters(cell["config"]))
    for seed in (2718281828, 1414213562, 1732050807):
        result = run.run_cell(cell, seed, 2.0, False, cuda_device)
        copies = seen[-1].state_copies
        print(NAME, seed, json.dumps({
            "params": n_params, "state_copies": copies, "host_copy_bytes": copies * 12 * n_params,
            "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "check_s": check_s[-1], "memory_peak_bytes": result["device"]["memory_peak_bytes"],
            "checked": result["checked"]}))
        assert result["correct"] is True, result["checked"]
        assert copies == 4


@pytest.mark.gpu
@pytest.mark.parametrize("envs", [64, 33])
def test_the_ssm_step_kernel_equals_the_plain_step(cuda_device, envs):
    """The new state to the bit (the same rounded products and sums, in
    the same order); ``y`` within float32 rounding of its sum over 128
    columns, which the kernel folds in another order than ``torch.sum``:
    each order is within ``127 u sum |s' C|`` of the exact sum (``u =
    2^-24``), and the ``D x`` term adds one rounding more."""
    from nnx_ppo_tpu_torch.ops.ssm_step import ssm_step_cuda, ssm_step_plain

    g = torch.Generator(device=cuda_device).manual_seed(envs)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    H, P, N = 64, 64, 128
    args = (rand(envs, H, P, N), rand(envs, H, P), torch.nn.functional.softplus(rand(envs, H)),
            -torch.exp(0.5 * rand(H)), rand(envs, N), rand(envs, N), rand(H))
    launches = ssm_step_cuda.launches
    new, y = ssm_step_cuda(*args)
    torch.cuda.synchronize()
    assert ssm_step_cuda.launches == launches + 1
    want_new, want_y = ssm_step_plain(*args)
    assert torch.equal(new, want_new)
    terms = (want_new * args[5][:, None, None, :]).abs().sum(-1) + (args[6][:, None] * args[1]).abs()
    bound = 2 * 128 * 2.0**-24 * terms
    assert bool(((y - want_y).abs() <= bound + 1e-30).all()), float((y - want_y).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_the_graphed_trunk_step_equals_the_eager_step(cuda_device, size):
    """The trunk's step replayed as a CUDA graph (its rollout step on a
    card) gives the eager step's output, counters and carry to the bit, control step after
    control step with episode ends between them: the same kernels on the
    same numbers. ``tiny``: the harness's tiny widths with ``d_state`` 32,
    the least the kernel takes; ``full``: the cell's widths at 64 envs."""
    from nnx_ppo_tpu_torch.core.struct import tree_leaves, tree_where
    from nnx_ppo_tpu_torch.networks import HybridTrunk

    _exact_float32()
    cfg = full_cell(NAME)["config"]
    envs, capacity = 64, cfg["network"]["kv_cache_capacity"]
    if size == "tiny":
        cfg, envs, capacity = dict(cfg, **dict(TINY_WIDTHS, mamba_d_state=32)), 8, 32
    trunk = HybridTrunk.create(
        cfg["hidden_size"], cfg["layer_types"], torch.Generator().manual_seed(3),
        intermediate=cfg["shared_intermediate_size"],
        mamba=dict(n_heads=cfg["mamba_n_heads"], head_dim=cfg["mamba_d_head"],
                   d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
                   chunk_size=cfg["mamba_chunk_size"]),
        attention=dict(n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
                       capacity=capacity, multiplier=cfg["attention_multiplier"]),
        residual_multiplier=cfg["residual_multiplier"],
        embedding_multiplier=cfg["embedding_multiplier"], eps=cfg["rms_norm_eps"],
        compute_dtype=cfg["compute_dtype"]).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    eager_state, graph_state = trunk.initialize_state(envs), trunk.initialize_state(envs)
    with torch.no_grad():
        for _ in range(6):
            x = torch.randn(envs, cfg["hidden_size"], generator=g, device=cuda_device)
            done = torch.rand(envs, generator=g, device=cuda_device) < 0.3
            a, b = trunk._step(eager_state, x), trunk(graph_state, x)
            assert torch.equal(a.output, b.output)
            assert torch.equal(a.metrics["counters"]["attention_cache_length"],
                               b.metrics["counters"]["attention_cache_length"])
            for p, q in zip(tree_leaves(a.next_state), tree_leaves(b.next_state), strict=True):
                assert torch.equal(p, q)
            eager_state = tree_where(done, trunk.reset_state(a.next_state), a.next_state)
            graph_state = tree_where(done, trunk.reset_state(b.next_state), b.next_state)
    assert len(trunk._graphs) == 1
