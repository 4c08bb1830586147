"""What sets the two phases of the captured train step on the card: the
benchmark cell train-coco-800 built as its generator builds it, one CUDA
graph of its step replayed in rounds for a minute, with each round's
readings beside its time.

    python3 artifacts/port_spans_r1/phase.py --seed N --rounds 66

Each round: 16 replays of the step timed with CUDA events (device ms a
step); 3 replays of a graph of 1000 stamp kernels (device microseconds a
kernel, a graph's cost per node alone); the host seconds spent inside the
16 ``replay()`` calls (sum and largest) and the process's CPU seconds;
the card's SM and memory clocks, power, state
and throttle reasons from ``nvidia-smi`` after it. Rounds ``--load_from``
to ``--load_to`` (exclusive) run with one busy-looping process a core
beside them, so a host under load can be told from one at rest; before
round ``--alloc_at`` ``--alloc_gb`` of device memory is allocated and freed
untouched, before ``--fill_at`` allocated, filled and freed, so that fresh
device memory can be told from the rest; before ``--graph_at`` a second
graph of stamps is captured, and before ``--step_at`` the step is captured
again in a second runner over the same state, which the later rounds
replay, so that a fresh capture can be told from the rest.

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
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from object_detection_destr_tpu_torch.ops.cuda.span_stamp import span_stamp  # noqa: E402
from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner  # noqa: E402
from port_bench.harness import registry  # noqa: E402
from port_bench.harness.coco_tree import write_coco_tree  # noqa: E402

CHUNK = 16
SMI = "clocks.sm,clocks.mem,power.draw,pstate,temperature.gpu,clocks_throttle_reasons.active"


def _card() -> dict:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI}", "--format=csv,noheader"], capture_output=True,
                         text=True)
    return dict(zip(SMI.split(","), (x.strip() for x in out.stdout.strip().split(","))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2950000001)
    ap.add_argument("--rounds", type=int, default=66)
    ap.add_argument("--load_from", type=int, default=24)
    ap.add_argument("--load_to", type=int, default=30)
    ap.add_argument("--alloc_at", type=int, default=34, help="allocate and free --alloc_gb untouched before this round")
    ap.add_argument("--fill_at", type=int, default=48, help="allocate, fill and free --alloc_gb before this round")
    ap.add_argument("--alloc_gb", type=float, default=16.0)
    ap.add_argument("--graph_at", type=int, default=40, help="capture a second graph of 1000 stamps before this round")
    ap.add_argument("--step_at", type=int, default=52,
                    help="capture the step again in a second runner before this round, and replay that one on")
    args = ap.parse_args()
    work = tempfile.mkdtemp(prefix="spans_phase_")
    dev = torch.device("cuda", 0)
    cell = registry.load_cell("train-coco-800")
    root = os.path.join(work, "coco")
    write_coco_tree(root, args.seed, cell.params["images"], sizes=[tuple(hw) for hw in cell.params["sizes"]])
    ctx = types.SimpleNamespace(cell=cell, seed=args.seed, log=print)
    runner, cache, state = registry.load_generator(cell.generator)._program(ctx, root, dev)
    _, idx = cache.epoch_index_matrix()
    runner.run(idx[:2], 0)  # the eager step, the capture and one replay
    torch.cuda.synchronize()

    host_s = []
    replay = runner.graph.replay

    def timed_replay():
        t = time.perf_counter()
        replay()
        host_s.append(time.perf_counter() - t)

    runner.graph.replay = timed_replay

    stamps = torch.zeros((1, 8), dtype=torch.int64, device=dev)
    slot = torch.zeros((1,), dtype=torch.int64, device=dev)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        span_stamp(stamps, slot, 0)
    torch.cuda.synchronize()
    stamp_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(stamp_graph):
        for i in range(1000):
            span_stamp(stamps, slot, i % 8)
    stamp_graph.replay()
    torch.cuda.synchronize()

    load, rounds, step = [], [], 2
    t_start = time.perf_counter()
    for r in range(args.rounds):
        if r == args.load_from:
            load = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(os.cpu_count() or 8)]
        if r == args.load_to:
            for p in load:
                p.kill()
                p.wait()
            load = []
        event = None
        if r in (args.alloc_at, args.fill_at):
            t_alloc = time.perf_counter()
            block = torch.empty((int(args.alloc_gb * 2**30),), dtype=torch.uint8, device=dev)
            if r == args.fill_at:
                block.fill_(1)
            torch.cuda.synchronize()
            del block
            torch.cuda.empty_cache()
            event = f"{'filled' if r == args.fill_at else 'allocated'} and freed {args.alloc_gb} GB in " \
                    f"{time.perf_counter() - t_alloc:.3f} s"
        if r == args.graph_at:
            t_capture = time.perf_counter()
            other = torch.cuda.CUDAGraph()
            with torch.cuda.graph(other):
                for i in range(1000):
                    span_stamp(stamps, slot, i % 8)
            other.replay()
            torch.cuda.synchronize()
            event = f"captured a graph of 1000 stamps in {time.perf_counter() - t_capture:.3f} s"
        if r == args.step_at:
            t_capture = time.perf_counter()
            runner = EpochRunner(state, runner.core, runner.transform, runner.data, runner.aug_seed,
                                 runner.steps_per_epoch, ema=runner.ema)
            runner.run(idx[:1], step)  # its eager step and capture
            torch.cuda.synchronize()
            replay = runner.graph.replay
            runner.graph.replay = timed_replay
            event = f"captured the step again in {time.perf_counter() - t_capture:.3f} s"
            step += 1
        chunk = idx[(step % (len(idx) - CHUNK)):][:CHUNK]
        times0 = os.times()
        host_s.clear()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        runner.run(chunk, step)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / CHUNK
        replays = list(host_s)
        per = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            stamp_graph.replay()
            b.record()
            torch.cuda.synchronize()
            per.append(a.elapsed_time(b))  # ms for 1000 kernels = us a kernel
        times1 = os.times()
        rounds.append({"round": r, "at_s": time.perf_counter() - t_start, "step_ms": step_ms,
                       "stamp_us": statistics.median(per), "replay_host_ms_sum": 1e3 * sum(replays),
                       "replay_host_ms_max": 1e3 * max(replays), "load": bool(load), "event": event,
                       "process_cpu_s": (times1.user + times1.system) - (times0.user + times0.system),
                       "card": _card()})
        print(json.dumps(rounds[-1]), flush=True)
        step += CHUNK
    for p in load:
        p.kill()
        p.wait()
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"seed": args.seed, "rounds": rounds}))


if __name__ == "__main__":
    main()
