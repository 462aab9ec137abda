"""The comparison that decides ``correct``.

Set-up builds the port's training state from the seed and drives it
through its first ``ppo_step`` calls, the window's own call on its own
traffic: three, each with every update followed, unless the
configuration's ``check`` block says otherwise (:func:`plan`); between
the calls the benchmark takes a snapshot of the state
(:meth:`Program.snapshot`). After the window, with the program's state
freed, the plain reference (``reference/``) follows those steps: it
checks the start (the envs the seed resets, and the network's carry,
against the program's first snapshot) and then runs each step from the
program's snapshot before it, and within it each control step of the
rollout from the program's env state and generator before it (read where
the rollout calls the env, :meth:`Program.check_steps`) and each
followed update from the program's parameters and moments before it, and
compares what it gets with what the program got. It follows so closely
because the rollout and the updates are chaotic: a rounding that differs
once would part the two trajectories within a few control steps or
updates, and a gap of the whole would then measure the chaos, not the
program. So an update that is not followed is not run either: the
reference never runs an update from its own result, which Adam would
amplify about twofold an update. (Where the program's rollout did not
pass through its env's ``step`` and ``reset`` once a control step, the
reference runs the rollout on from its own states and only the step's
end is compared.)

The numbers compared, each against a limit of ``limits/<cell>.json``:

* ``env_gap``: the env state after each control step (and the start),
  worst field: ``|p - r| / |r|`` in the 2-norm over the envs for floats,
  the share of differing entries for flags and counters; 1 more where
  the generator's state differs (a draw more or less);
* ``loss_gap``: each step's loss (the mean over its followed updates of
  the total loss; with every update followed, the port's own mean over
  the step), ``|p - r| / |r|``, worst step;
* ``grad_gap``: Adam's first moment after the first step (its
  gradients as the optimizer got them), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf;
* ``update_gap``: each followed update's change of every parameter, the
  same measure, worst leaf and update;
* ``change_gap``: the parameters' change over the checked steps, as the
  next step starts from them, the same measure (where updates are left
  out, the change over the followed ones);
* ``stats_gap`` (configurations with a normalizer): the normalizer's
  count, mean and M2 after each step, ``|p - r| / |r|``, worst;
* ``carry_gap`` (configurations whose network carries state): the carry
  at the start and after each checked step, the reference's carried
  through the step's control steps from the program's carry at its
  start, measured as ``env_gap``.

Leaves whose reference gradient is nought to rounding (first moment
under a thousandth of the median leaf's) are left out of the changes.
"""

from __future__ import annotations

import math

import torch

from portbench import cells
from portbench.reference import ppo as ref_ppo

GRAD_FLOOR = 1e-3
BETA1 = 0.9
CHECK_STEPS = 3
STATE_KEYS = ("params", "adam_m", "adam_v", "adam_count", "stats", "env", "carry")


def plan(cell: dict) -> tuple:
    """``(checked steps, followed updates)`` of a cell: the
    configuration's ``check`` block, ``{"steps": n, "updates": [j, ...]}``
    (indices into a step's ``E M`` updates, negative ones from the end;
    the first and the last are always followed), or three steps with
    every update followed."""
    t = cell["traffic"]
    n = t["n_epochs"] * t["n_minibatches"]
    block = cell["config"].get("check", {})
    if "updates" not in block:
        return block.get("steps", CHECK_STEPS), list(range(n))
    return block.get("steps", CHECK_STEPS), sorted({0, n - 1} | {j % n for j in block["updates"]})


def kept_updates(followed: list, n: int) -> list:
    """The updates of a step of ``n`` whose state the program copies for
    ``followed``: each followed update's and the one before it, but the
    last, whose state is the step's end."""
    return sorted((set(followed) | {j - 1 for j in followed if j > 0}) - {n - 1})


def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def rel(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.double(), r.double()
    den = torch.linalg.vector_norm(r).item()
    num = torch.linalg.vector_norm(p - r).item()
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def env_gap(p: dict, r: dict) -> float:
    if set(p) != set(r):
        return math.inf
    worst = 0.0
    for k in p:
        a, b = p[k].to(r[k].device), r[k]
        if a.shape != b.shape:
            return math.inf
        if a.is_floating_point():
            gap = rel(a, b)
        else:
            gap = (a != b).double().mean().item()
        worst = max(worst, gap)
    return worst


def leaf_gap(p: dict, r: dict, keep=None) -> float:
    """Worst leaf of ``| |p| - |r| | / max(|r|, median leaf |r|)``."""
    names = [k for k in r if keep is None or k in keep]
    pn = {k: torch.linalg.vector_norm(p[k].double().to(r[k].device)).item() for k in names}
    rn = {k: torch.linalg.vector_norm(r[k].double()).item() for k in names}
    median = sorted(rn.values())[len(rn) // 2]
    return max(abs(pn[k] - rn[k]) / max(rn[k], median, 1e-300) for k in names)


def diff(a: dict, b: dict) -> dict:
    return {k: a[k].to(b[k].device) - b[k] for k in b}


class Reference:
    """The plain reference of one cell on ``device``."""

    def __init__(self, cell: dict, device, precision=None, fault=None):
        self.cell, self.device, self.fault = cell, device, fault
        cfg = cell["config"]
        self.module = cells.load_module("reference", cell["entry"]["config"])
        self.precision = precision or cfg["compute_dtype"]
        self.task = self.module.task(cfg, device)
        self.net = self.module.Net(cfg, self.precision)
        self.carried = hasattr(self.net, "initial_carry")
        self.ppo = dict(cfg["ppo"], **cell["traffic"])
        self.physics = None

    def generator(self, state=None, seed=None) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        if seed is not None:
            gen.manual_seed(seed)
        else:
            gen.set_state(state)
        return gen

    def start(self, seed: int) -> tuple:
        """The envs a generator seeded with ``seed`` resets, and the
        generator after it."""
        gen = self.generator(seed=seed)
        with torch.no_grad():
            env = self.task.reset(self.cell["traffic"]["n_envs"], gen)
        return env, gen.get_state()

    def initial_carry(self) -> dict:
        return self.net.initial_carry(self.cell["traffic"]["n_envs"], self.device)

    def iterate(self, snap: dict, follow=None, follow_controls=None) -> dict:
        """One step from the state ``snap`` (a program's snapshot), each
        update and control step from the program's state before it where
        ``follow`` and ``follow_controls`` give the program's (``follow``:
        the updates to run, see :func:`ref_ppo.ppo_iteration`)."""
        state = _to({k: snap[k] for k in STATE_KEYS if k in snap}, self.device)
        state["generator"] = self.generator(snap["generator"])
        if self.physics is None and hasattr(self.task, "control_step"):
            self.physics = graphed(self.task, state["env"], self.device)
        if follow_controls is not None:
            # A generator's state stays on the host.
            follow_controls = [{"env": _to(c["env"], self.device), "generator": c["generator"]}
                               for c in follow_controls]
        out = ref_ppo.ppo_iteration(self.task, self.net, state, self.ppo, self.physics,
                                    self.fault, _to(follow, self.device), follow_controls)
        out["generator"] = out["generator"].get_state()
        return out


def graphed(task, env: dict, device):
    """The task's control step captured once as a CUDA graph and
    replayed: the same kernels on the same numbers, without the host
    launching each of the lane math's thousands of small operations.
    ``False`` (eager) on the CPU."""
    if torch.device(device).type != "cuda":
        return False
    keys = ["qpos", "qvel"] + ["dr." + n for n in task.dr_fields]
    static = {k: env[k].clone() for k in keys}
    B = env["qpos"].shape[0]
    target = torch.zeros((B, task.n_act), device=device)
    push = tuple(torch.zeros(B, device=device) for _ in range(3))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        task.control_step(static, target, push)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), torch.no_grad():
        out = task.control_step(static, target, push)

    def run(s, tgt, psh):
        for k in keys:
            static[k].copy_(s[k])
        target.copy_(tgt)
        for a, b in zip(push, psh):
            a.copy_(b)
        graph.replay()
        return tuple(o.clone() for o in out)

    return run


def state_gap(p_env: dict, p_gen, r_env: dict, r_gen) -> float:
    """``env_gap`` of two env states, plus 1 where the generators differ."""
    return env_gap(p_env, r_env) + (0.0 if torch.equal(p_gen.cpu(), r_gen.cpu()) else 1.0)


def program_update(snap: dict, j: int) -> dict:
    """The program's parameters and moments after update ``j`` of the
    step that ended in ``snap``."""
    if j in snap["updates"]:
        return snap["updates"][j]
    if j == snap["n_updates"] - 1:
        return {"params": snap["params"], "m": snap["adam_m"], "v": snap["adam_v"]}
    raise KeyError(f"update {j} was not copied")


def compare(snaps: list, losses: list, seed: int, ref: Reference, detail=None) -> dict:
    """Every number compared, from the program's snapshots ``snaps``
    (before the first step and after each, with each step's control
    steps, followed updates and carry) and step losses ``losses``.
    ``detail``, a dict, receives each step's readings."""
    T = ref.ppo["rollout_length"]
    n_updates = ref.ppo["n_epochs"] * ref.ppo["n_minibatches"]
    if ("carry" in snaps[0]) != ref.carried:
        raise ValueError("the configuration's carry_state and its reference's carry disagree")
    start_env, start_gen = ref.start(seed)
    env = [state_gap(snaps[0]["env"], snaps[0]["generator"], start_env, start_gen)]
    carry = [env_gap(snaps[0]["carry"], ref.initial_carry())] if ref.carried else []
    loss, update, stats, ref_losses = [], [], [], []
    grad, moved = None, None
    whole = all(len(s["followed"]) == s["n_updates"] for s in snaps[1:])
    total = {k: torch.zeros_like(v) for k, v in snaps[0]["params"].items()}
    mine_total = None if whole else {k: torch.zeros_like(v) for k, v in total.items()}
    for k in range(1, len(snaps)):
        snap, followed = snaps[k], snaps[k]["followed"]
        controls = snap["controls"]
        if len(controls) != T or not all("generator" in c for c in controls):
            controls = None
        # An optimizer step more or fewer than the algorithm takes.
        sound = snap["n_updates"] == n_updates
        follow = ({j: None if j == 0 else program_update(snap, j - 1) for j in followed}
                  if sound else {0: None})
        out = ref.iterate(snaps[k - 1], follow, controls)
        if controls is not None:
            # Each control step but the last against the state that
            # entered the next and the generator after its resets; the
            # last against the step's end, below.
            env += [state_gap(controls[t + 1]["env"], controls[t]["generator"],
                              out["controls"][t]["env"], out["controls"][t]["generator"])
                    for t in range(T - 1)]
        env.append(state_gap(snap["env"], snap["generator"], out["env"], out["generator"]))
        if ref.carried:
            carry.append(env_gap(snap["carry"], out["carry"]))
        if out["stats"]:
            stats.append(max(rel(snap["stats"][n].to(ref.device), out["stats"][n])
                             for n in out["stats"]))
        if not sound:
            loss.append(math.inf)
            update.append(math.inf)
            grad = math.inf if grad is None else grad
            continue
        lr = out["loss"].double().item()
        ref_losses.append(lr)
        lp = (float(losses[k - 1]) if len(followed) == n_updates
              else sum(snap["update_losses"][j] for j in followed) / len(followed))
        loss.append(abs(lp - lr) / abs(lr) if lr != 0 else math.inf)
        for j in followed:
            mine, theirs = program_update(snap, j), out["updates"][j]
            before = snaps[k - 1]["params"] if j == 0 else program_update(snap, j - 1)["params"]
            if grad is None:
                # The first gradient as the optimizer got it, from its
                # first moment after one update: m = (1 - b1) g.
                grad = leaf_gap({n: x / (1.0 - BETA1) for n, x in mine["m"].items()},
                                theirs["grads"])
                rn = {n: torch.linalg.vector_norm(t.double()).item()
                      for n, t in theirs["grads"].items()}
                median = sorted(rn.values())[len(rn) // 2]
                moved = {n for n, x in rn.items() if x >= GRAD_FLOOR * median}
            step_mine, step_ref = diff(mine["params"], before), diff(theirs["params"], before)
            update.append(leaf_gap(step_mine, step_ref, moved))
            for n in total:
                total[n] += step_ref[n]
                if mine_total is not None:
                    mine_total[n] += step_mine[n]
    if not math.isfinite(max(update)):
        change = math.inf
    else:
        mine_change = (diff(snaps[-1]["params"], snaps[0]["params"]) if mine_total is None
                       else mine_total)
        change = leaf_gap(mine_change, total, moved)
    if detail is not None:
        detail.update(env_by_step=env, loss_by_step=loss, update_by_update=update,
                      leaves_left_out=sorted(set(total) - (moved or set())),
                      reference_losses=ref_losses, program_losses=[float(x) for x in losses])
        if carry:
            detail["carry_by_step"] = carry
    gaps = {"env_gap": max(env), "loss_gap": max(loss), "grad_gap": grad,
            "update_gap": max(update), "change_gap": change}
    if stats:
        gaps["stats_gap"] = max(stats)
    if carry:
        gaps["carry_gap"] = max(carry)
    return gaps


def reference_as_program(ref: Reference, seed: int, weights: dict, n_steps: int,
                         followed=None) -> tuple:
    """Snapshots and losses of ``n_steps`` steps with the reference
    ``ref`` (another precision, or a fault planted) in the program's
    place, from the state the seed and ``weights`` make, read as the
    program's are for the updates ``followed`` (default: every one)."""
    env, gen = ref.start(seed)
    snap = {
        "params": {k: v.detach().clone() for k, v in weights.items()},
        "adam_m": {k: torch.zeros_like(v) for k, v in weights.items()},
        "adam_v": {k: torch.zeros_like(v) for k, v in weights.items()},
        "adam_count": 0,
        "stats": initial_stats(ref),
        "env": env,
        "generator": gen,
    }
    if ref.carried:
        snap["carry"] = ref.initial_carry()
    snaps, losses = [snap], []
    for _ in range(n_steps):
        before = snaps[-1]["env"]
        out = ref.iterate(snaps[-1])
        losses.append(out.pop("loss").item())
        n = len(out["updates"])
        out["followed"] = list(range(n)) if followed is None else followed
        out["n_updates"] = n
        out["update_losses"] = [out["updates"][j]["loss"].item() for j in range(n)]
        out["updates"] = {j: {k: out["updates"][j][k] for k in ("params", "m", "v")}
                          for j in kept_updates(out["followed"], n)}
        # As the program's are read: the state that entered each control
        # step and the generator after its resets.
        entered = [before] + [c["env"] for c in out["controls"][:-1]]
        out["controls"] = [{"env": e, "generator": c["generator"]}
                           for e, c in zip(entered, out["controls"])]
        snaps.append(out)
    return snaps, losses


def initial_stats(ref: Reference) -> dict:
    fn = getattr(ref.module, "initial_stats", None)
    return {} if fn is None else fn(ref.cell["config"], ref.device)


def verdict(gaps: dict, limits: dict) -> bool:
    return set(gaps) <= set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in gaps.items())
