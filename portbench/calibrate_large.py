"""``calibrate.py``'s readings for a configuration too large for its
stand-ins' records: the same command, arguments and output,

    python3 -m portbench.calibrate_large --workload <cell> --seeds 1,2,3 \\
        [--reorder-seeds ...] [--control-seeds ...] [--fault-seeds ...] [--out FILE]

A stand-in (the reference in the program's place) runs a whole step, and
``reference/ppo.py`` keeps every update's parameters, moments and
gradients: sixteen updates of ``granite_h_micro``'s 746M parameters are
some 190 GB, more than the card holds. Here each stand-in's update drops
its gradients, which a stand-in's reading never compares, and the state
of every update that the configuration's ``check`` block does not compare
(``check.kept_updates``) once the next update has taken it up; the kept
ones, and every snapshot of the stand-in, go to the host. What is
compared, and how, is ``calibrate.py``'s: the program's readings are its
own, and the stand-ins' snapshots hold the same numbers.
"""

from __future__ import annotations

import contextlib
import itertools
import sys

from portbench import calibrate, check
from portbench.reference import ppo as ref_ppo

HOST = "cpu"


@contextlib.contextmanager
def lean_updates(kept: set, n: int):
    """While open, ``reference/ppo.py``'s updates keep no gradients, and
    the state of an update of a step of ``n`` that is not in ``kept``
    (its index within the step) only until the next update has started
    from it; a kept state is copied to the host then."""
    update = ref_ppo.update
    index = itertools.count()
    pending = []

    def lean(*args, **kwargs):
        j = next(index) % n
        if pending:
            record, keep = pending.pop()
            for k in ("params", "m", "v"):
                state = record.pop(k)
                if keep:
                    record[k] = {name: t.to(HOST) for name, t in state.items()}
        out = update(*args, **kwargs)
        del out["grads"]
        if j < n - 1:
            pending.append((out, j in kept))
        return out

    ref_ppo.update = lean
    try:
        yield
    finally:
        ref_ppo.update = update


def stand_in_reading(cell: dict, seed: int, device, kind: str, precision=None,
                     fault=None) -> dict:
    """:func:`calibrate.stand_in_reading` with the stand-in's updates
    lean and its snapshots on the host."""
    from portbench import cells, program

    ref_module = cells.load_module("reference", cell["entry"]["config"])
    weights = program.make_weights(ref_module.parameters(cell["config"]), seed, device)
    stand_in = check.Reference(cell, device, precision=precision, fault=fault)
    n_steps, followed = check.plan(cell)
    n = cell["traffic"]["n_epochs"] * cell["traffic"]["n_minibatches"]
    with lean_updates(set(check.kept_updates(followed, n)), n):
        snaps, losses = check.reference_as_program(stand_in, seed, weights, n_steps, followed)
    del weights, stand_in
    snaps = [check._to(s, HOST) for s in snaps]
    detail: dict = {}
    gaps = check.compare(snaps, losses, seed, check.Reference(cell, device), detail)
    return {"kind": kind, "seed": seed, "gaps": gaps, **detail}


def main(argv=None) -> None:
    calibrate.stand_in_reading = stand_in_reading
    calibrate.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
