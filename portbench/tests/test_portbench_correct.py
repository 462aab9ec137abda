"""The comparison that decides ``correct``, on the CPU at a size a test
holds: the port agrees with the reference; the control (the reference in
the precision below the configuration's, in the program's place) and
each fault a one-card training cell can have, planted in the port under
a whole run of the harness, come out not correct; so does each fault of
a network's carry; the ``check`` block's subset of updates copies only
the states it needs."""

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
    snaps, losses = program.Program(cell, 99, CPU, weights).check_steps(*check.plan(cell))
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

        # Env rows are the first dimension of a batch-major minibatch's
        # sequences, the second of a time-major one's (a recurrent net's).
        rows = 0 if minibatch.batch_major else 1
        h = minibatch.done.shape[rows] // 2
        cut = lambda tree: tree_map(lambda x: x[:h], tree)  # noqa: E731
        seq = lambda tree: tree_map(lambda x: x.narrow(rows, 0, h), tree)  # noqa: E731
        minibatch = dataclasses.replace(
            minibatch, obs=seq(minibatch.obs), old_loglikelihoods=seq(minibatch.old_loglikelihoods),
            rewards=seq(minibatch.rewards), done=seq(minibatch.done),
            truncated=seq(minibatch.truncated), rollout_extras=seq(minibatch.rollout_extras),
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


def _carry_not_reset(monkeypatch):
    from nnx_ppo_tpu_torch.networks import GRU

    monkeypatch.setattr(GRU, "reset_state", lambda self, prev_state: prev_state)


def _replay_from_zero(monkeypatch):
    from nnx_ppo_tpu_torch.algorithms import ppo
    from nnx_ppo_tpu_torch.core.struct import tree_map

    loss = ppo.ppo_loss

    def zero(networks, state, *args, **kwargs):
        return loss(networks, tree_map(torch.zeros_like, state), *args, **kwargs)

    monkeypatch.setattr(ppo, "ppo_loss", zero)


def _carries_of_other_rows(monkeypatch):
    from nnx_ppo_tpu_torch.algorithms import ppo
    from nnx_ppo_tpu_torch.core.struct import tree_map

    update = ppo.ppo_update

    def shifted(networks, opt_state, network_states, *args, **kwargs):
        moved = tree_map(lambda x: torch.roll(x, 1, dims=0), network_states)
        return update(networks, opt_state, moved, *args, **kwargs)

    monkeypatch.setattr(ppo, "ppo_update", shifted)


CARRY_FAULTS = {"carry_not_reset": _carry_not_reset, "replay_from_zero": _replay_from_zero,
                "carries_of_other_rows": _carries_of_other_rows}
# Rollouts long enough that episodes end inside the checked steps (the
# cart-pole falls after some tens of control steps), where a carry that
# is not reset shows.
CARRY_ROLLOUT = 20


@pytest.mark.parametrize("fault", sorted(CARRY_FAULTS))
def test_a_carry_fault_in_the_port_is_not_correct(monkeypatch, fault):
    cell = tiny_cell("cartpole_gru.e1024", rollout_length=CARRY_ROLLOUT)
    assert run.run_cell(cell, 4242, 0.5, False, CPU)["correct"] is True
    CARRY_FAULTS[fault](monkeypatch)
    result = run.run_cell(cell, 4242, 0.5, False, CPU)
    assert result["correct"] is False, result["checked"]
    if fault == "carry_not_reset":
        assert result["checked"]["carry_gap"]["value"] > result["checked"]["carry_gap"]["limit"]


def test_the_default_check_follows_every_update_and_reads_no_carry():
    cell = tiny_cell("mlp_wide_bf16.e8192")
    n = cell["traffic"]["n_epochs"] * cell["traffic"]["n_minibatches"]
    assert "check" not in cell["config"]
    assert check.plan(cell) == (3, list(range(n)))
    reading = calibrate.program_reading(cell, 5150, CPU)
    assert len(reading["update_by_update"]) == 3 * n
    assert "carry_gap" not in reading["gaps"]
    assert check.verdict(reading["gaps"], cell["limits"]), reading["gaps"]


@pytest.mark.parametrize("name", ["mlp_wide_bf16.e8192", "cartpole_gru.e1024"])
def test_a_subset_of_updates_copies_only_the_states_it_needs(name):
    """Two steps of four updates, the first and the last followed: the
    program copies the three step boundaries and, in each step, the
    state after the first update and the one the last starts from; the
    comparison follows two updates a step and is correct."""
    from portbench import cells, program

    cell = tiny_cell(name)
    cell["config"] = dict(cell["config"], check={"steps": 2, "updates": [-1]})
    steps, followed = check.plan(cell)
    assert (steps, followed) == (2, [0, 3])
    weights = program.make_weights(
        cells.load_module("reference", cell["entry"]["config"]).parameters(cell["config"]), 61, CPU)
    prog = program.Program(cell, 61, CPU, weights)
    snaps, losses = prog.check_steps(steps, followed)
    assert prog.state_copies == 3 + 2 * 2
    assert [sorted(s["updates"]) for s in snaps[1:]] == [[0, 2], [0, 2]]
    assert [s["n_updates"] for s in snaps[1:]] == [4, 4]
    detail: dict = {}
    gaps = check.compare(snaps, losses, 61, check.Reference(cell, CPU), detail)
    assert len(detail["update_by_update"]) == 2 * 2
    assert check.verdict(gaps, cell["limits"]), gaps
    whole = program.Program(cell, 61, CPU, weights)
    whole.check_steps(3, list(range(4)))
    assert whole.state_copies == 4 + 3 * 3


def test_a_subset_holds_the_control_and_the_port_alike():
    """With a subset followed, the control still comes out not correct
    and a sound run correct, through a whole run of the harness."""
    cell = tiny_cell("mlp_wide_bf16.e8192")
    cell["config"] = dict(cell["config"], check={"steps": 1, "updates": []})
    control = CONTROL_OF[cell["config"]["compute_dtype"]]
    reading = calibrate.stand_in_reading(cell, 778, CPU, "control", precision=control)
    assert not check.verdict(reading["gaps"], cell["limits"]), reading["gaps"]
    assert run.run_cell(cell, 2**33 + 5, 0.5, False, CPU)["correct"] is True
