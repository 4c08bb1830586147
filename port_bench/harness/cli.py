"""One run of one cell: set-up, the measured window, the metrics of the cell
by their readers, the comparison with the reference, and the result line.

The generator named by the cell's traffic mix does the work in two calls:
``measure(ctx) -> run`` (set-up, the window, the device's readings, and the
program's state freed) and ``check(ctx, run) -> {number: (value, limit)}``
(the reference after the window). A number passes where it does not exceed
its limit. Each metric of the cell is then read from ``run`` by
``port_bench/metrics/<name>.py``; a reader that finds nothing returns None
and the metric is left out of the line."""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Callable

from . import isolation, registry

__all__ = ["Ctx", "main", "run_cell"]


@dataclasses.dataclass
class Ctx:
    """What a generator is given."""

    cell: registry.Cell
    seed: int
    seconds: float
    trace: bool
    started: float  # the process's start on time.perf_counter's clock
    work_dir: str  # scratch for the run's inputs (under TMPDIR), removed at the end
    log: Callable[[str], None]


def _log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="port_bench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="inputs and weights come from it")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: trace the window and report the per-layer metrics")
    return p


def _device(count: int) -> dict:
    import torch

    if not torch.cuda.is_available():  # a test's run on the CPU
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def run_cell(ctx: Ctx) -> tuple[int, dict]:
    """(exit code, result line) of one run: the generator's window and
    check, the isolation check, the metrics by their readers."""
    generator = registry.load_generator(ctx.cell.generator)
    run = generator.measure(ctx)
    checks = generator.check(ctx, run)
    found = isolation.forbidden_modules(sys.modules)
    if found:
        _log(f"port_bench: the process holds modules of JAX or the JAX package: {', '.join(sorted(found))}")
        return 4, {}
    metrics = {}
    for spec in registry.metrics_for(ctx.cell.name, ctx.trace):
        value = registry.load_reader(spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    checks = {k: (float(v), float(limit)) for k, (v, limit) in checks.items()}
    unreadable = [k for k, m in metrics.items() if not math.isfinite(m["value"])]
    if unreadable:
        _log(f"port_bench: metrics with no finite value: {', '.join(unreadable)}")
        return 5, {}
    correct = all(math.isfinite(v) and v <= limit for v, limit in checks.values())
    device = {**_device(int(ctx.cell.entry["chips"])), "memory_peak_bytes": int(run["memory_peak_bytes"])}
    if ctx.trace and run.get("trace"):
        device.update(busy_s=run["trace"]["busy_s"], window_s=run["trace"]["window_s"])
    line = {"correct": correct, "attempted": int(run["attempted"]), "failed": int(run["failed"]),
            "metrics": metrics, "device": device}
    if ctx.trace and run.get("breakdown"):
        line["breakdown"] = run["breakdown"]
    # a number that is not finite is written as a string, so that the line stays JSON
    line["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": limit} for k, (v, limit) in checks.items()}
    for k, (v, limit) in checks.items():
        _log(f"check {k}: {v!r} (limit {limit!r}){'' if v <= limit else ' FAILED'}")
    return 0, line


def main(argv: list[str], started: float) -> int:
    args = _parser().parse_args(argv)
    cell = registry.load_cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"port_bench: the cell {cell.name} needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 3
    torch.cuda.init()
    _log(f"start: Python, torch and the CUDA context {time.perf_counter() - started:.2f} s")
    work_dir = os.path.join(tempfile.gettempdir(), f"port_bench_{cell.name}")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    try:
        code, line = run_cell(Ctx(cell, args.seed, args.seconds, bool(args.trace), started, work_dir, _log))
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    if code == 0:
        print(json.dumps(line), flush=True)
    return code
