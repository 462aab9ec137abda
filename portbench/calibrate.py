"""The readings that the limits of ``limits/<cell>.json`` are set from,
for one cell, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--reorder-seeds 4,5] [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--out FILE]

* for each of ``--seeds``: the port's training state from the seed, its
  checked ``ppo_step`` calls (``check.plan``) and the reference's
  comparison, as a run makes them (no window): the lower readings;
* for each of ``--reorder-seeds``: the reference in the configuration's
  precision with every product's sums in another order (``/split``), in
  the program's place: what a sound change of a GEMM's algorithm reads,
  a lower reading beside the program's;
* for each of ``--control-seeds``: the control, the reference computed
  in the precision below the configuration's (``CONTROL_OF``), put in
  the program's place and compared as the program is: the upper
  readings;
* for each of ``--fault-seeds`` and each fault a training cell can have
  on one card: half of each minibatch left out with the means taken
  over the rest, one env's advantages altered where they are made, and,
  where the network carries state, the carry not reset where an episode
  ends, planted in the reference put in the program's place. (A step
  that leaves its state unchanged reads 1 by ``change_gap``'s measure
  and needs no run.)

``--workload`` names a cell of ``BENCHMARK.json`` or, for a
configuration that has no cell yet, ``<config>.<traffic>`` of the
files under ``configs/`` and ``traffic/``.

Each reading is one JSON line (on standard output, and appended to
``--out``): the kind, the seed, every number compared, and, for the
program's runs, each step's loss on both sides. It runs on the card
(``--device cuda``) or, at a size a test holds, on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from portbench import cells, check
from portbench.reference.precision import CONTROL_OF

FAULTS = ("half_batch", "advantage")
CARRY_FAULTS = ("carry_reset",)


def program_reading(cell: dict, seed: int, device) -> dict:
    """The sound program's numbers at ``seed``."""
    from portbench import program

    ref_module = cells.load_module("reference", cell["entry"]["config"])
    weights = program.make_weights(ref_module.parameters(cell["config"]), seed, device)
    prog = program.Program(cell, seed, device, weights)
    snaps, losses = prog.check_steps(*check.plan(cell))
    del prog
    detail: dict = {}
    gaps = check.compare(snaps, losses, seed, check.Reference(cell, device), detail)
    return {"kind": "program", "seed": seed, "gaps": gaps, **detail}


def stand_in_reading(cell: dict, seed: int, device, kind: str, precision=None,
                     fault=None) -> dict:
    """The numbers of the reference in the program's place, computed in
    ``precision`` or with ``fault`` planted."""
    from portbench import program

    ref_module = cells.load_module("reference", cell["entry"]["config"])
    weights = program.make_weights(ref_module.parameters(cell["config"]), seed, device)
    stand_in = check.Reference(cell, device, precision=precision, fault=fault)
    snaps, losses = check.reference_as_program(stand_in, seed, weights, *check.plan(cell))
    detail: dict = {}
    gaps = check.compare(snaps, losses, seed, check.Reference(cell, device), detail)
    return {"kind": kind, "seed": seed, "gaps": gaps, **detail}


def readings(cell: dict, device, seeds=(), control_seeds=(), fault_seeds=(), reorder_seeds=()):
    """Every reading asked for, one dict each, as they are made."""
    dtype = cell["config"]["compute_dtype"]
    control = CONTROL_OF[dtype]
    for seed in seeds:
        yield program_reading(cell, seed, device)
    for seed in reorder_seeds:
        yield stand_in_reading(cell, seed, device, "reordered", precision=f"{dtype}/split")
    for seed in control_seeds:
        yield stand_in_reading(cell, seed, device, f"control_{control}", precision=control)
    faults = FAULTS + (CARRY_FAULTS if check.Reference(cell, device).carried else ())
    for seed in fault_seeds:
        for fault in faults:
            yield stand_in_reading(cell, seed, device, f"fault_{fault}", fault=fault)


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--reorder-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = cells.benchmark(Path.cwd())
    if args.workload in {w["name"] for w in bench["workloads"]}:
        cell = cells.cell(bench, args.workload)
    else:
        config, traffic = args.workload.split(".", 1)
        cell = cells.assemble(bench, {"name": args.workload, "config": config,
                                      "traffic": traffic, "chips": 1}, {})
    device = torch.device(args.device)
    for reading in readings(cell, device, seeds(args.seeds), seeds(args.control_seeds),
                            seeds(args.fault_seeds), seeds(args.reorder_seeds)):
        reading["t"] = time.time()
        line = json.dumps(reading)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
