#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 port_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. Every build and kernel cache stays inside the
checkout; nothing here imports JAX or the JAX package."""

import os
import sys
import time


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (Linux: from
    /proc; elsewhere the moment this module runs)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


STARTED = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".port_bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from port_bench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
