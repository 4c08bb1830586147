"""The readings that the limits of a cell's compared numbers are set from,
on the card at the cell's own size, several seeds in one process:

    python3 port_bench/tests/calibrate.py --workload CELL --seeds 11,12,13 \
        --seconds 2 [--control [int8|fp8]] [--fault half|unchanged] [--out FILE]

For each seed it runs the cell (set-up, a short window at the cell's load,
the reference) and prints the numbers the run compares. ``--control``
prints instead the control's numbers: the reference computed one precision
below the configuration's bfloat16 (int8, or float8) held to the
reference, on the inputs a run of that seed checks. ``--fault`` plants
a fault in the program (``faults.py``). The lower reading of a number is
the largest over sound seeds, its upper the smallest of the control's and
of the faults'."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from port_bench.harness import cli, compare, device, registry  # noqa: E402
from port_bench.reference import steps as reference  # noqa: E402
from port_bench.tests.faults import planted  # noqa: E402


def control_numbers(ctx, run, lower: str = "int8") -> dict:
    """The reference one precision below (``lower``), held to the reference."""
    cfg, dev, p = ctx.cell.config, device.cuda_or_cpu(), ctx.cell.params
    rows = reference.epoch_rows(p["images"], cfg["train"]["batch_size"], ctx.seed)[:p["check_steps"]]
    ref = reference.train_steps(cfg, ctx.seed, run["tree"], rows, dev)
    low = reference.train_steps(cfg, ctx.seed, run["tree"], rows, dev, lower=lower)
    return compare.train_numbers(low, ref)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", nargs="?", const="int8", choices=["int8", "fp8"],
                   help="the control's numbers (int8 if no format is named)")
    p.add_argument("--fault", choices=["half", "unchanged"])
    p.add_argument("--out", help="also append the JSON lines here")
    args = p.parse_args()
    cell = registry.load_cell(args.workload)
    generator = registry.load_generator(cell.generator)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        work = tempfile.mkdtemp(prefix="port_bench_calibrate_")
        ctx = cli.Ctx(cell, seed, args.seconds, False, time.perf_counter(), work, lambda m: print(m, file=sys.stderr))
        with planted(args.fault):
            run = generator.measure(ctx)
        if args.control:
            numbers = control_numbers(ctx, run, args.control)
        else:
            numbers = generator.numbers(ctx, run)
        kind = f"control-{args.control}" if args.control else args.fault or "program"
        row = {"cell": cell.name, "seed": seed, "kind": kind,
               "numbers": {k: float(v) for k, v in numbers.items()}}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
        shutil.rmtree(work, ignore_errors=True)
    keys = rows[0]["numbers"]
    print(json.dumps({"cell": cell.name, "kind": rows[0]["kind"], "seeds": len(rows),
                      "max": {k: max(r["numbers"][k] for r in rows) for k in keys},
                      "min": {k: min(r["numbers"][k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
