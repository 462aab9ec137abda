"""The window's rate and percentile, the trace's reduction, the frozen
counts and the FLOP formula against numbers worked by hand."""

from __future__ import annotations

import json

import pytest

from portbench import cells, peaks, run, trace
from portbench.counts import control_step, gae, networks
from portbench.tests.conftest import ROOT


def config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


TRAFFIC = {"n_envs": 8192, "rollout_length": 20, "n_epochs": 4, "n_minibatches": 4,
           "world_size": 1}


def test_rate_and_p90_on_synthetic_times():
    assert run.rate(10, TRAFFIC, 4.0) == pytest.approx(10 * 8192 * 20 / 4.0)
    p90 = cells.reader("step_ms.p90")
    assert p90({"step_s": [0.1 * i for i in range(1, 11)]}) == pytest.approx(900.0)
    assert p90({"step_s": [0.3, 0.1, 0.2]}) == pytest.approx(300.0)
    assert p90({"step_s": []}) is None


def test_trace_reduction_on_synthetic_events():
    # Two steps, [0, 1] and [1, 2] s; kernels busy 0.1-0.3, 0.2-0.5, 1.5-1.6.
    events = [("ppo_step", False, 0.0, 1.0), ("ppo_step", False, 1.0, 1.0),
              ("unroll_env", False, 0.0, 0.6), ("unroll_env", False, 1.0, 0.4),
              ("ppo_update", False, 0.6, 0.4), ("aten::mul", False, 0.55, 0.4),
              ("aten::randn", False, 0.9, 0.2),
              ("ppo_step", True, 0.0, 2.0), ("Optimizer.step#Adam.step", False, 0.6, 0.1),
              ("Optimizer.step#Adam.step", True, 0.6, 0.3),
              ("control_step_kernel", True, 0.1, 0.2), ("gae_kernel", True, 0.2, 0.3),
              ("Memcpy HtoD", True, 1.5, 0.1)]
    r = trace.reduce(events, 2)
    assert r["window_s"] == pytest.approx(2.0)
    assert r["busy_s"] == pytest.approx(0.5)
    assert len(r["device_ops"]) == 3
    assert r["ranges"]["unroll_env"] == pytest.approx([0.6, 0.4])
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps[0][1] == pytest.approx(1.0) and gaps[0][0] == "unroll_env > aten::randn"
    record = {"trace": r, "steps": 2, "config": config("quadruped_rough"), "traffic": TRAFFIC}
    assert cells.reader("idle_share")(record) == pytest.approx(75.0)
    assert cells.reader("kernels_per_step")(record) == pytest.approx(1.0)
    assert cells.reader("rollout_ms")(record) == pytest.approx(500.0)
    assert cells.reader("update_ms")(record) == pytest.approx(400.0)


def test_network_flops_by_hand():
    # Quadruped: encoders 3x32 and 42x128, actor 160x128 and 128x24, two
    # critics of 160x128 and 128x1: 70,240 multiply-adds a sample.
    q = config("quadruped_rough")
    assert networks.forward_flops_per_sample(q) == 2 * (96 + 5376 + 20480 + 3072 + 2 * 20608)
    assert networks.flops_per_step(q, TRAFFIC) == 140_480 * 163_840 * 13
    # Wide MLP: actor 5x1024, 3 x 1024x1024, 1024x2; critic 5x2048,
    # 2048x2048, 2048x1.
    m = config("mlp_wide_bf16")
    actor = 5 * 1024 + 3 * 1024 * 1024 + 1024 * 2
    critic = 5 * 2048 + 2048 * 2048 + 2048
    assert networks.forward_flops_per_sample(m) == 2 * (actor + critic)
    record = {"config": m, "traffic": TRAFFIC, "steps": 1, "window_s": 1.0}
    expect = 100 * 2 * (actor + critic) * 163_840 * 13 / 989e12
    assert cells.reader("mfu")(record) == pytest.approx(expect)


def test_frozen_kernel_counts_by_hand():
    q = config("quadruped_rough")
    ops, n_bytes = control_step.per_launch(q, TRAFFIC)
    assert (ops, n_bytes) == (98_931 * 8192, 404 * 8192)
    assert n_bytes == 4 * (19 + 18 + 12 + 7 + 19 + 18 + 8) * 8192
    assert control_step.least_seconds(q, TRAFFIC) == pytest.approx(98_931 * 8192 / 67e12)
    assert control_step.per_launch(config("mlp_wide_bf16"), TRAFFIC) is None
    # GAE, two keys at b = 2048, T = 20: 26 bytes an element, 8 a row.
    ops, n_bytes = gae.per_launch(q, TRAFFIC)
    assert n_bytes == 2048 * 20 * 26 + 2048 * 8
    assert gae.least_seconds(q, TRAFFIC) == pytest.approx(n_bytes / peaks.HBM_BYTES_PER_S)
    record = {"config": q, "traffic": TRAFFIC,
              "trace": {"device_ops": [("gae_kernel", 0.0, 4e-6), ("gae_kernel", 1.0, 6e-6)]}}
    assert cells.reader("gae_roofline")(record) == pytest.approx(100 * n_bytes / 3.35e12 / 5e-6)
    assert cells.reader("control_step_roofline")(record) is None


def test_control_step_count_is_the_reference_lane_math():
    """98,931 is what the reference's control step counts, on 8 envs."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from portbench.reference.legged import LeggedTask

    counted = {"ops": 0}
    arithmetic = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "sin", "cos", "sinc",
                  "pow", "clamp", "where", "gt", "reciprocal"}

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in arithmetic and torch.is_tensor(out):
                counted["ops"] += out.numel()
            return out

    task = LeggedTask(config("quadruped_rough")["env"], "cpu")
    gen = torch.Generator().manual_seed(3)
    s = task.reset(8, gen)
    push = (torch.full((8,), 50.0), torch.zeros(8), torch.zeros(8))
    with Counter():
        task.control_step(s, task.default_pose.expand(8, 12), push)
    assert counted["ops"] / 8 == control_step.FROZEN["quadruped_rough"][0]
