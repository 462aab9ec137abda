"""The span reduction (``spans.py``) against numbers worked by hand, on
synthetic Kineto events of one step, and of two, and on a real CPU
profile of the port's ``ppo_step``."""

from __future__ import annotations

import pytest

from portbench import spans

US = 1000  # ns


def _step(offset_us: int = 0, corr: int = 0, device_late_us: int = 0) -> list:
    """One step's events as :func:`spans.events` gives them, times in µs
    from ``offset_us``: three idle gaps (0-12, 260-430, 700-720), eight
    launched operations, one with no launch (the ``orphan``), one that
    starts 15 µs before its launch, the backward's two kernels launched
    from thread 2 while thread 1 sits in ``update.backward``, and one
    ``cudaStreamSynchronize``; the device's times ``device_late_us`` late."""

    def host(name, start, end, thread=1, c=0, annotation=False):
        return (name, False, (offset_us + start) * US, (end - start) * US, thread,
                c and c + corr, annotation)

    def span(name, start, end):
        return host(name, start, end, annotation=True)

    def launch(c, at, thread=1):
        return host("cudaLaunchKernel", at, at + 3, thread, c)

    def op(name, c, start, end):
        return (name, True, (offset_us + device_late_us + start) * US, (end - start) * US, 7,
                c + corr, False)

    return [
        span("ppo_step", 0, 1000), span("unroll_env", 1, 400), span("rollout.env", 100, 300),
        span("ppo_update", 400, 990), span("update.loss", 410, 500),
        span("update.backward", 500, 700), span("update.optimizer", 700, 800),
        span("Optimizer.step#Adam.step", 703, 790),
        launch(1, 10), op("policy_gemm", 1, 12, 110),
        launch(2, 105), op("env_kernel", 2, 110, 250),
        host("cudaMemcpyAsync", 200, 204, 1, 3), op("Memcpy HtoD (Pageable -> Device)", 3, 250, 260),
        launch(4, 420), op("loss_gemm", 4, 430, 520),
        # A host operation whose own correlation id is a launch's: not a launch.
        host("aten::mm", 415, 419, 1, 5),
        launch(5, 505, thread=2), op("backward_gemm", 5, 520, 640),
        launch(6, 510, thread=2), op("backward_gemm", 6, 640, 700),
        launch(7, 715), op("adam_kernel", 7, 720, 760),
        op("orphan_kernel", 99, 760, 800),
        launch(9, 815), op("early_kernel", 9, 800, 1000),
        host("cudaStreamSynchronize", 850, 950, 1, 10),
        # The device's copy of a range: no operation.
        ("update.backward", True, (offset_us + device_late_us + 520) * US, 180 * US, 7, 0, True),
    ]


# One step, by hand (µs): inclusive device time, self device time,
# kernels, inclusive idle, self idle, syncs, launches from another thread.
ONE_STEP = {
    "ppo_step": (758, 0, 7, 202, 0, 1, 2),
    "unroll_env": (248, 98, 2, 182, 182, 0, 0),
    "rollout.env": (150, 150, 1, 0, 0, 0, 0),
    "ppo_update": (510, 200, 5, 20, 0, 1, 2),
    "update.loss": (90, 90, 1, 0, 0, 0, 0),
    "update.backward": (180, 180, 2, 0, 0, 0, 2),
    "update.optimizer": (40, 0, 1, 20, 0, 0, 0),
    "Optimizer.step#Adam.step": (40, 40, 1, 20, 20, 0, 0),
}
HOST_US = {"ppo_step": 1000, "unroll_env": 399, "rollout.env": 200, "ppo_update": 590,
           "update.loss": 90, "update.backward": 200, "update.optimizer": 100,
           "Optimizer.step#Adam.step": 87}


@pytest.mark.parametrize("n_steps", [1, 2])
def test_span_record_on_synthetic_events(n_steps):
    events = [e for k in range(n_steps) for e in _step(1000 * k, 100 * k)]
    r = spans.reduce(events, n_steps)
    us = 1e-6 * n_steps
    assert r["steps"] == n_steps
    assert r["window_s"] == pytest.approx(1000 * us)
    assert r["busy_s"] == pytest.approx(798 * us)
    assert r["device_s"] == pytest.approx(798 * us)
    assert r["coverage"] == pytest.approx(758 / 798)
    assert r["early_ops"] == n_steps
    assert r["launch_lag_s"] == pytest.approx([-15e-6] * n_steps)
    assert set(r["spans"]) == set(ONE_STEP)
    for name, (device, device_self, kernels, idle, idle_self, syncs, other) in ONE_STEP.items():
        got = r["spans"][name]
        assert got["calls"] == n_steps
        assert got["host_s"] == pytest.approx(HOST_US[name] * us)
        assert got["device_s"] == pytest.approx(device * us), name
        assert got["device_self_s"] == pytest.approx(device_self * us), name
        assert got["kernels"] == kernels * n_steps, name
        assert got["idle_s"] == pytest.approx(idle * us), name
        assert got["idle_self_s"] == pytest.approx(idle_self * us), name
        assert got["syncs"] == syncs * n_steps, name
        assert got["other_thread_launches"] == other * n_steps, name
    # Every idle µs and every launched operation's µs falls to the step.
    step = r["spans"]["ppo_step"]
    assert step["idle_s"] == pytest.approx(r["window_s"] - r["busy_s"])
    assert step["device_s"] == pytest.approx(r["coverage"] * r["device_s"])


def test_a_late_device_clock_moves_no_time_between_spans():
    """Device times 60 µs late (the card's clock drifts from the host's):
    each operation still falls to its launch's span and each idle gap to
    the span the host was in; only the window's first gap, longer now,
    falls to the step."""
    r = spans.reduce(_step(device_late_us=60), 1)
    assert r["window_s"] == pytest.approx(1060e-6)
    assert r["busy_s"] == pytest.approx(798e-6)
    assert r["early_ops"] == 0
    assert r["launch_lag_s"] == pytest.approx([45e-6])
    idle = {"ppo_step": (262, 72), "unroll_env": (170, 170), "ppo_update": (20, 0),
            "update.optimizer": (20, 0), "Optimizer.step#Adam.step": (20, 20)}
    for name, (device, device_self, *_) in ONE_STEP.items():
        got = r["spans"][name]
        assert got["device_s"] == pytest.approx(device * 1e-6), name
        assert got["device_self_s"] == pytest.approx(device_self * 1e-6), name
        assert (got["idle_s"] * 1e6, got["idle_self_s"] * 1e6) == pytest.approx(
            idle.get(name, (0, 0))), name


def test_without_the_inner_spans_their_time_falls_to_the_parents():
    """A program with only ``ppo_step``, ``unroll_env`` and ``ppo_update``
    (and the optimizer's own range) reads the same inclusive figures."""
    inner = ("rollout.env", "update.loss", "update.backward", "update.optimizer")
    r = spans.reduce([e for e in _step() if e[0] not in inner], 1)
    assert set(r["spans"]) == set(ONE_STEP) - set(inner)
    unroll, update = r["spans"]["unroll_env"], r["spans"]["ppo_update"]
    assert unroll["device_self_s"] == pytest.approx(248e-6)
    assert update["device_s"] == pytest.approx(510e-6)
    assert update["device_self_s"] == pytest.approx(470e-6)
    assert update["other_thread_launches"] == 2


def test_no_step_or_no_device_operation_gives_an_empty_record():
    events = _step()
    for kept in ([e for e in events if e[0] != "ppo_step"], [e for e in events if not e[1]]):
        r = spans.reduce(kept, 1)
        assert r["spans"] == {} and r["busy_s"] == 0.0 and r["launch_lag_s"] == []


def test_events_of_a_cpu_profile_of_ppo_step():
    """The fields read exist on this PyTorch; on the CPU no operation runs
    on a device, so the record is empty, and the step's spans are there."""
    from torch.profiler import ProfilerActivity, profile

    from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer, new_training_state, ppo_step
    from nnx_ppo_tpu_torch.envs import CartpoleBalance
    from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
    from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

    config = PPOConfig(n_envs=8, rollout_length=2, n_epochs=1, n_minibatches=2)
    env = EpisodeWrapper(CartpoleBalance(), 50)
    net = make_mlp_actor_critic(5, 1, [8], [8], 0)
    optimizer = make_optimizer(config.learning_rate)
    state = new_training_state(env, net, config.n_envs, 0, optimizer=optimizer, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ppo_step(env, state, config, optimizer)
    events = spans.events(prof)
    names = [e[0] for e in events if e[6]]
    assert names.count("rollout.env") == 2 and names.count("update.backward") == 2
    assert all(isinstance(e[2], int) and isinstance(e[5], int) for e in events)
    assert spans.reduce(events, 1)["spans"] == {}
