"""The comparison that decides ``correct``, on the CPU at a size a test
holds: the port agrees with the reference; the control (the reference in
the precision below the configuration's, in the program's place) and
each fault a one-card training cell can have, planted in the port under
a whole run of the harness, come out not correct."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import calibrate, check, run
from portbench.reference.precision import CONTROL_OF
from portbench.tests.conftest import CELLS, tiny_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(name):
    cell = tiny_cell(name)
    reading = calibrate.program_reading(cell, 20240531, CPU)
    assert check.verdict(reading["gaps"], cell["limits"]), reading["gaps"]
    assert reading["gaps"]["env_gap"] == 0.0
    # Every control step was followed: the start, then T a step.
    assert len(reading["env_by_step"]) == 1 + 3 * cell["traffic"]["rollout_length"]


def test_a_rollout_not_read_step_by_step_is_compared_at_its_end():
    """Where the program's rollout did not pass through its env's
    ``step`` and ``reset`` once a control step, the reference runs the
    rollout on from its own states and compares the step's end."""
    from portbench import cells, program

    cell = tiny_cell("mlp_wide_bf16.e8192")
    ref_module = cells.load_module("reference", cell["entry"]["config"])
    weights = program.make_weights(ref_module.parameters(cell["config"]), 99, CPU)
    snaps, losses = program.Program(cell, 99, CPU, weights).check_steps(3)
    for snap in snaps[1:]:
        snap["controls"] = snap["controls"][:-1]
    detail: dict = {}
    gaps = check.compare(snaps, losses, 99, check.Reference(cell, CPU), detail)
    assert check.verdict(gaps, cell["limits"]), gaps
    assert len(detail["env_by_step"]) == 4


@pytest.mark.parametrize("name", CELLS)
def test_a_reordered_gemm_is_correct(name):
    """A sound change of a GEMM's algorithm, the reference in the
    configuration's precision with its sums in another order put in the
    program's place, stays inside every limit."""
    cell = tiny_cell(name)
    reordered = cell["config"]["compute_dtype"] + "/split"
    reading = calibrate.stand_in_reading(cell, 31337, CPU, "reordered", precision=reordered)
    assert check.verdict(reading["gaps"], cell["limits"]), reading["gaps"]
    assert reading["gaps"]["env_gap"] > 0.0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    control = CONTROL_OF[cell["config"]["compute_dtype"]]
    reading = calibrate.stand_in_reading(cell, 777, CPU, "control", precision=control)
    assert not check.verdict(reading["gaps"], cell["limits"]), reading["gaps"]


def _half_batch(ppo):
    loss = ppo.ppo_loss

    def half(networks, state, minibatch, *args, **kwargs):
        from nnx_ppo_tpu_torch.core.struct import tree_map

        h = minibatch.done.shape[0] // 2
        cut = lambda tree: tree_map(lambda x: x[:h], tree)  # noqa: E731
        minibatch = dataclasses.replace(
            minibatch, obs=cut(minibatch.obs), old_loglikelihoods=cut(minibatch.old_loglikelihoods),
            rewards=cut(minibatch.rewards), done=minibatch.done[:h],
            truncated=minibatch.truncated[:h], rollout_extras=cut(minibatch.rollout_extras),
            last_next_obs=cut(minibatch.last_next_obs))
        return loss(networks, cut(state), minibatch, *args, **kwargs)

    return "ppo_loss", half


def _altered_answer(ppo):
    gae = ppo.gae_per_key

    def altered(*args, **kwargs):
        from nnx_ppo_tpu_torch.core.struct import tree_map

        def bump(a):
            a = a.clone()
            a[0] += 1.0
            return a

        return tree_map(bump, gae(*args, **kwargs))

    return "gae_per_key", altered


def _unchanged_state(ppo):
    step = ppo.Optimizer.step

    def skipped(self, opt_state):
        # Zero gradients: the step leaves every parameter where it was.
        for p in opt_state.param_groups[0]["params"]:
            if p.grad is not None:
                p.grad.zero_()
        group = opt_state.param_groups[0]
        saved = {p: {k: v.clone() for k, v in opt_state.state[p].items()} for p in group["params"]}
        params = [p.detach().clone() for p in group["params"]]
        step(self, opt_state)
        with torch.no_grad():
            for p, before in zip(group["params"], params):
                p.copy_(before)
                opt_state.state[p].update(saved[p])

    return None, skipped


FAULTS = {"half_batch": _half_batch, "altered_answer": _altered_answer,
          "unchanged_state": _unchanged_state}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_run_with_a_fault_in_the_port_is_not_correct(monkeypatch, name, fault):
    from nnx_ppo_tpu_torch.algorithms import ppo

    attr, broken = FAULTS[fault](ppo)
    if attr is None:
        monkeypatch.setattr(ppo.Optimizer, "step", broken)
    else:
        monkeypatch.setattr(ppo, attr, broken)
    result = run.run_cell(tiny_cell(name), 4242, 0.5, False, CPU)
    assert result["correct"] is False, result["checked"]
    assert result["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = run.run_cell(tiny_cell(name), 2**31 + 11, 0.5, False, CPU)
    assert result["correct"] is True, result["checked"]
    assert list(result)[-1] == "checked"
    assert set(result["metrics"]) == {"train_sps", "setup_s"}
