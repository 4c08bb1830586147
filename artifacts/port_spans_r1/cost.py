"""What the device spans cost on the card, and where the traced window's
idle gaps fall: the benchmark cell train-coco-800 built as its generator
builds it (``port_bench/generators/train_epochs.py::_program``), on one
CUDA device.

    python3 artifacts/port_spans_r1/cost.py --seed N --rounds 8

1. Two epoch runners over the one train state: A captured with no span
   recorder (the benchmark's graph), B captured with one active. Then
   ``--rounds`` rounds of 16 replays of A and 16 of B, in turns, each
   timed with CUDA events around the 16 launches: device ms a step of
   each, and B's spans (median ms a step).
2. One more call of 16 replays of A traced as the benchmark traces it
   (``port_bench/harness/trace.py::Trace``, a range a step), with its idle
   gaps and every host event at each gap's middle.
3. A graph of 1000 stamps, replayed: device microseconds a stamp.

Prints one JSON line last. Imports torch, the port and the benchmark's
harness only."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from object_detection_destr_tpu_torch.ops.cuda.span_stamp import span_stamp  # noqa: E402
from object_detection_destr_tpu_torch.runtime import spans as runtime_spans  # noqa: E402
from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner  # noqa: E402
from port_bench.harness import registry  # noqa: E402
from port_bench.harness.coco_tree import write_coco_tree  # noqa: E402
from port_bench.harness.spans import summarize  # noqa: E402
from port_bench.harness.trace import Trace, parse_trace  # noqa: E402

CHUNK = 16


def _card() -> dict:
    q = "name,power.limit,clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_throttle_reasons.active"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"], capture_output=True, text=True)
    return dict(zip(q.split(","), (x.strip() for x in out.stdout.strip().split(","))))


def _timed(runner, idx, base) -> float:
    """Device ms a step of CHUNK replays (CUDA events around the launches)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    runner.run(idx, base)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(idx)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2950000001)
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    work = tempfile.mkdtemp(prefix="spans_cost_")
    dev = torch.device("cuda", 0)
    cell = registry.load_cell("train-coco-800")
    root = os.path.join(work, "coco")
    write_coco_tree(root, args.seed, cell.params["images"], sizes=[tuple(hw) for hw in cell.params["sizes"]])
    ctx = types.SimpleNamespace(cell=cell, seed=args.seed, log=print)
    plain, cache, state = registry.load_generator(cell.generator)._program(ctx, root, dev)
    _, idx = cache.epoch_index_matrix()
    spanned = EpochRunner(state, plain.core, plain.transform, plain.data, plain.aug_seed, plain.steps_per_epoch,
                          ema=plain.ema)
    rec = runtime_spans.SpanRecorder(dev, CHUNK)
    plain.run(idx[:1], 0)
    with runtime_spans.recording(rec):
        spanned.run(idx[1:2], 1)
    step = 2
    card_before = _card()
    ms = {"plain": [], "spans": []}
    rows, cards = [], []
    for r in range(args.rounds):
        cards.append(_card())  # between rounds, the device idle
        order = ("plain", "spans") if r % 2 == 0 else ("spans", "plain")
        for side in order:
            chunk = idx[(step % (len(idx) - CHUNK)):][:CHUNK]
            if side == "plain":
                ms[side].append(_timed(plain, chunk, step))
            else:
                with runtime_spans.recording(rec):
                    ms[side].append(_timed(spanned, chunk, step))
                rows += rec.read(CHUNK)
            step += CHUNK
    card_after = _card()
    spans = summarize(rows)

    # the benchmark's trace of one call of the plain graph
    trace = Trace(work)
    trace.start()
    plain.run(idx[:CHUNK], step, step_scope=lambda s: Trace.range(f"step {s}"))
    path = trace.stop()
    parsed = parse_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in
            ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")]
    intervals = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                       if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    gaps, end = [], None
    for a, b in intervals:
        if end is not None and a - end > 20.0:  # microseconds
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    t0 = intervals[0][0]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:12]:
        mid = (a + b) / 2
        around = sorted((float(e.get("dur", 0.0)), e["name"]) for e in host
                        if float(e["ts"]) <= mid <= float(e["ts"]) + float(e.get("dur", 0.0)))
        named.append({"us": b - a, "at_us": a - t0, "host": [n for _, n in around][:6],
                      # every host event that overlaps the gap: (name, start, end) from the gap's start
                      "overlapping": sorted((e["name"], round(float(e["ts"]) - a, 1),
                                             round(float(e["ts"]) + float(e.get("dur", 0.0)) - a, 1))
                                            for e in host if float(e["ts"]) < b and
                                            float(e["ts"]) + float(e.get("dur", 0.0)) > a)[:40]})

    # a stamp's device time: 1000 stamps in one graph
    stamps = torch.zeros((1, 8), dtype=torch.int64, device=dev)
    slot = torch.zeros((1,), dtype=torch.int64, device=dev)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        span_stamp(stamps, slot, 0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(1000):
            span_stamp(stamps, slot, i % 8)
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per = []
    for _ in range(5):
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(stop))  # ms for 1000 stamps = us a stamp
    out = {"card_before": card_before, "card_after": card_after, "cards": cards, "seed": args.seed,
           "step_ms": {k: v for k, v in ms.items()},
           "median_ms": {k: statistics.median(v) for k, v in ms.items()},
           "spans_ms": spans["ms"], "spans_self_ms": spans["self_ms"], "spans_rows": len(rows),
           "trace": {"busy_ms_a_step": parsed["busy_s"] * 1e3 / CHUNK, "window_ms": parsed["window_s"] * 1e3,
                     "gaps": parsed["gaps"][:10], "gaps_with_host": named},
           "stamp_us": statistics.median(per)}
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
