"""One run of one benchmark cell of the port, ``nnx_ppo_tpu_torch``:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. In order: build the cell's env, networks
(weights made on the card from the seed), optimizer and training state;
drive its first ``ppo_step`` calls (three, unless the configuration's
``check`` block says otherwise: ``check.plan``), snapshotting the state
between them (they are also the warm-up: every kernel is built and every
shape run); time a window of whole ``ppo_step`` calls for ``--seconds``;
with ``--trace 1`` time each step of the window on its own and then
profile two more steps; free the program's state; follow the checked
steps with the plain reference (``check.py``); print the comparisons on
standard error and one JSON line on standard output.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones. The run refuses to report without a CUDA device, and
when a JAX module has been loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PROFILED_STEPS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nnx_ppo_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(message: str, code: int = 2):
    print(message, file=sys.stderr, flush=True)
    sys.exit(code)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(program, seconds: float, each_step: bool, device) -> dict:
    """Whole ``ppo_step`` calls for ``seconds``, from a synchronize to a
    synchronize; with ``each_step`` every step ends in one and is timed."""
    import torch

    from portbench.program import step_loss

    sync(device)
    t0 = time.perf_counter()
    losses, step_s = [], []
    while True:
        ts = time.perf_counter()
        losses.append(step_loss(program.step()))
        if each_step:
            sync(device)
            step_s.append(time.perf_counter() - ts)
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses))).sum().item())
    return {"window_s": elapsed, "steps": len(losses), "failed": failed, "step_s": step_s}


def rate(steps: int, traffic: dict, seconds: float) -> float:
    """Env steps trained per second: ``n_envs T`` per completed step."""
    return steps * traffic["n_envs"] * traffic["rollout_length"] / seconds


def finite(x: float) -> float:
    """A gap as JSON can carry it: an infinite or undefined one as 1e300."""
    return x if math.isfinite(x) else 1e300


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device) -> dict:
    """One run of ``cell`` on ``device``: the result's fields (see the
    module docstring), ``setup_s`` counted from the process's start."""
    import torch

    from portbench import cells, check, program, trace

    ref_module = cells.load_module("reference", cell["entry"]["config"])
    weights = program.make_weights(ref_module.parameters(cell["config"]), seed, device)
    prog = program.Program(cell, seed, device, weights)
    del weights
    snaps, losses = prog.check_steps(*check.plan(cell))
    sync(device)
    setup_s = time.perf_counter() - T_START

    timed = window(prog, seconds, traced, device)
    profiled = trace.profile(prog.step, PROFILED_STEPS) if traced else None
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del prog
    if on_card:
        torch.cuda.empty_cache()

    detail: dict = {}
    gaps = check.compare(snaps, losses, seed, check.Reference(cell, device), detail)
    print(f"leaves left out of the changes: {detail['leaves_left_out']}", file=sys.stderr)
    correct = check.verdict(gaps, cell["limits"]) and timed["failed"] == 0

    traffic = cell["traffic"]
    metrics = {}
    if traced:
        record = {"config": cell["config"], "traffic": traffic, **timed, "trace": profiled}
        for m in cell["per_layer"]:
            value = cells.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "train_sps": rate(timed["steps"], traffic, timed["window_s"]),
            "setup_s": setup_s,
        }
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell["entry"]["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": timed["steps"], "failed": timed["failed"],
              "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = profiled["busy_s"]
        device_info["window_s"] = profiled["window_s"]
        result["breakdown"] = profiled["breakdown"]
    result["checked"] = {k: {"value": finite(v), "limit": cell["limits"].get(k, 0.0)}
                         for k, v in gaps.items()}
    return result


def main(argv=None) -> None:
    args = parse(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").exists():
        fail("BENCHMARK.json not found: run from the root of a checkout")
    import torch

    from portbench import cells

    cell = cells.cell(cells.benchmark(root), args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    if cell["traffic"]["world_size"] != 1:
        fail("this harness runs world size 1 only; a mix of world size > 1 needs its launcher")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)

    found = forbidden_modules()
    if found:
        fail(f"JAX modules loaded in the benchmark's process: {found}", 3)
    for k, c in result["checked"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"failed_steps {result['failed']} limit 0", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
