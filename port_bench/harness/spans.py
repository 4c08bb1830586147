"""The spans stretch of a traced training run, and its reduction to device
milliseconds a step by layer.

The program marks its training step with spans stamped on the device's own
clock (``object_detection_destr_tpu_torch/runtime/spans.py``:
``SpanRecorder``, ``span``). A step captured while a recorder is active
holds the stamps, and each replay writes its own row; a step captured
without one is the plain step, which the window and the traced steps run.
So the stretch runs after them, when the first span metric is read: the
program is built again as the cell's generator builds it (``_program``,
over the run's tree and seed), a recorder is made active, and steps run
through the epoch runner: the eager first step and the capture, then
rounds of ``STEPS`` replays, timed on the host, each round's rows reduced
to each span's median duration and self time.

An H100 runs one captured step in one of two phases, 72.8-73.3 or
74.6-75.8 ms a step: the slower adds a cost to every node of every graph
on the device (1.15-1.2 against 0.97-1.0 us a node in a graph of stamps
alone) and follows a capture of the step, for 2.5 to 12 s or more
(PERF.md §7). The traced steps' busy time a step (the union of their
kernels) is the device's own work, and the untraced window's step reads
the same in the faster phase. The stretch is to describe that step, so the
rounds stop at the first whose ``step`` lies within ``AGREE`` of the busy
time, or at ``ROUNDS`` (about 7 s), and the round closest to it gives the
metrics; each round's ``step`` is kept and logged, and ``agrees`` says
which phase the metrics come from. ``run["spans"]`` keeps them for the other
readers:

    {"steps": STEPS, "ms": {span: median ms}, "self_ms": {span: median ms},
     "parent": {span: parent span or None}, "images_per_s": the round's
     images over its host seconds, "window_images_per_s": the window's,
     "busy_ms": the traced steps' busy time a step, "round": the round
     used, "rounds_step_ms": each round's ``step``, "agrees": whether the
     round used lies within ``AGREE``}

A run without a trace, or a program without ``runtime/spans.py``, gives
None: the readers then return None and the line leaves the metrics out. A
stretch that fails fails the run."""

from __future__ import annotations

import argparse
import gc
import importlib
import statistics
import sys
import time
import types
from typing import Optional, Sequence

import numpy as np

STEPS = 16  # replays a round
ROUNDS = 6  # rounds at most
AGREE = 0.015  # a round agrees with the traced steps where its step is within this share of their busy time


def _log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def _seed() -> Optional[int]:
    """The run's ``--seed`` from the command line (``port_bench/run.py``)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--seed", type=int)
    return parser.parse_known_args(sys.argv[1:])[0].seed


def summarize(rows: list[dict]) -> dict:
    """``SpanRecorder.read``'s rows reduced to each span's median ms and
    self ms a step, and its parent."""
    names = list(rows[0]["spans"])
    median = lambda key: {n: statistics.median(r["spans"][n][key] for r in rows) for n in names}
    return {"steps": len(rows), "ms": median("ms"), "self_ms": median("self_ms"),
            "parent": {n: rows[0]["spans"][n]["parent"] for n in names}}


def _program_spans():
    """The program's span module; None where the program has none."""
    name = "object_detection_destr_tpu_torch.runtime.spans"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name == name:
            return None
        raise


def stretch(run: dict, seed: int) -> Optional[dict]:
    """Run the stretch for ``run`` (see the module doc); None where the
    program has no span recorder."""
    program_spans = _program_spans()
    if program_spans is None:
        return None
    from port_bench.harness import device, registry

    cell = registry.load_cell(run["cell"])
    generator = registry.load_generator(cell.generator)
    ctx = types.SimpleNamespace(cell=cell, seed=seed, log=_log)
    dev = device.cuda_or_cpu()
    t0 = time.perf_counter()
    runner, cache, state = generator._program(ctx, run["tree"], dev)
    epochs = []
    while sum(len(i) for i in epochs) < 1 + ROUNDS * STEPS:  # the epochs the steps take, as the window takes them
        if epochs:
            cache.advance_epoch()
        epochs.append(cache.epoch_index_matrix()[1])
    idx = np.concatenate(epochs)
    trace = run["trace"]
    busy_ms = 1e3 * trace["busy_s"] / trace["steps"]
    batch = cell.config["train"]["batch_size"]
    recorder = program_spans.SpanRecorder(dev, STEPS)
    rounds = []
    with program_spans.recording(recorder):
        runner.run(idx[:1], 0)  # the eager step and the capture, which holds the stamps
        for r in range(ROUNDS):
            pos = 1 + r * STEPS
            device.synchronize(dev)
            t_round = time.perf_counter()
            runner.run(idx[pos:pos + STEPS], pos)  # rows 0 .. STEPS - 1, read at the call's end
            seconds = time.perf_counter() - t_round
            rounds.append({**summarize(recorder.read(STEPS)), "images_per_s": STEPS * batch / seconds})
            if abs(rounds[-1]["ms"]["step"] / busy_ms - 1.0) <= AGREE:
                break
    steps_ms = [r["ms"]["step"] for r in rounds]
    used = min(range(len(rounds)), key=lambda i: abs(steps_ms[i] - busy_ms))
    out = {**rounds[used], "window_images_per_s": run["images"] / run["window_s"], "busy_ms": busy_ms,
           "round": used, "rounds_step_ms": steps_ms, "agrees": abs(steps_ms[used] / busy_ms - 1.0) <= AGREE}
    del runner, cache, state
    gc.collect()
    device.empty_cache(dev)
    _log(f"spans: rounds of {STEPS} replays, step " + ", ".join(f"{ms:.3f}" for ms in steps_ms)
         + f" ms against the traced steps' busy {busy_ms:.3f} ms a step; round {used} used "
         f"({'within' if out['agrees'] else 'outside'} {AGREE:.1%}); {out['images_per_s']:.2f} images/s, the "
         f"window {out['window_images_per_s']:.2f}; stretch {time.perf_counter() - t0:.2f} s in all")
    for name, ms in out["ms"].items():
        _log(f"span {name} (in {out['parent'][name]}): {ms:.4f} ms, self {out['self_ms'][name]:.4f} ms")
    return out


def spans(run: dict) -> Optional[dict]:
    """``run["spans"]``, from the stretch at the first call of a traced run."""
    if "spans" not in run:
        seed = _seed()
        if not run.get("trace") or "tree" not in run or "cell" not in run or seed is None:
            return None
        run["spans"] = stretch(run, seed)
    return run["spans"]


def span_ms(run: dict, names: Sequence[str]) -> Optional[float]:
    """The sum of the spans' median device ms a step; None without them."""
    found = spans(run)
    if not found or any(n not in found["ms"] for n in names):
        return None
    return sum(found["ms"][n] for n in names)
