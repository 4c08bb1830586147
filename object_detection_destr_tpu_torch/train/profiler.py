"""Step timing and device traces (port of
``object_detection_destr_tpu/train/profiler.py``).

* :class:`StepTimer`: epoch throughput from the host clock around work that
  ends in a synchronize, and on a GPU each step's time from CUDA events;
* :class:`StepTrace`: a ``torch.profiler`` trace (CPU and CUDA activities)
  from ``start()`` to ``stop()`` around a range of steps, each step marked by
  a ``record_function`` range, exported as a Chrome trace (``--profile_dir``);
* :func:`parse_trace`: what the device did in such a trace: each marked
  step's device busy seconds and period, the device busy time and idle share
  of the window, the kernel launches by name, and each device event name's
  count and summed duration (the counterpart of the JAX package's
  ``device_step_seconds``, and of the op table of ``tools/profile_step.py``).

A device event (kernel, memcpy, memset) belongs to the step whose host range
holds the runtime call that launched it (the trace's ``correlation`` id; a
CUDA graph's replay is one ``cudaGraphLaunch`` whose kernels all carry its
id). An event whose launch the trace does not hold, or whose launch lies in
no marked step, is counted as unattributed. The window runs
from the first step's first device event to the last step's last one; a
step's period from its first device event to the next step's first (to its
own last for the last step), so the periods add up to the window and
``1 - busy / period`` is the share of the step the device sat idle, waiting
for the host.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time

import torch

__all__ = ["StepTimer", "StepTrace", "parse_trace"]

STEP_PREFIX = "odtt_step "  # the name of a step's record_function range: prefix + label
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class StepTimer:
    """Epoch throughput from the host clock around work that ends in a
    synchronize, and on a GPU each step's time from CUDA events recorded
    between steps (``step_ms``)."""

    def __init__(self, batch_size: int, device: torch.device):
        self.batch_size = batch_size
        self.cuda = device.type == "cuda"
        self.step_ms: list[float] = []
        self._events: list = []
        self._t0 = 0.0
        self._steps = 0

    def _mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._events.append(event)

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._events = []
        self._mark()

    def step(self) -> None:
        self._steps += 1
        self._mark()

    def stop(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
            self.step_ms += [a.elapsed_time(b) for a, b in zip(self._events, self._events[1:])]
        dt = time.perf_counter() - self._t0
        steps = max(self._steps, 1)
        return {"seconds": dt, "steps_per_sec": steps / dt, "images_per_sec": steps * self.batch_size / dt}


class StepTrace:
    """A ``torch.profiler`` trace of some steps: ``start()``, one ``with
    step(label):`` around each step's work, ``stop()`` (waits for the device,
    exports ``profile_dir/trace_<time>.json`` and returns its path). CUDA
    activities are traced where a GPU is present.

    On a GPU the trace stays open ``MARGIN_S`` on each side of the steps with
    the device idle. The profiler keeps only the device events whose time,
    put on the host's clock, lies inside its window, and the two clocks
    disagree by milliseconds from trace to trace (``parse_trace``'s
    ``launch_lead_s`` below 0: a kernel that starts before the host call
    that launched it). Without the margins the first device events of a
    window, or the last ones of a CUDA graph's replay that ends just before
    ``stop()``, can be lost."""

    MARGIN_S = 0.25

    def __init__(self, profile_dir: str):
        self.profile_dir = profile_dir
        self._prof = None

    def start(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            time.sleep(self.MARGIN_S)

    def step(self, label) -> contextlib.AbstractContextManager:
        return torch.profiler.record_function(f"{STEP_PREFIX}{label}")

    def stop(self) -> str:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            time.sleep(self.MARGIN_S)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        return path


def _newest_trace(path: str) -> str:
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True), key=os.path.getmtime)
        if not found:
            raise FileNotFoundError(f"no trace (*.json) under {path}")
        return found[-1]
    return path


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, microseconds in,
    seconds out."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e6


def parse_trace(path: str) -> dict:
    """Read a Chrome trace that :class:`StepTrace` exported (a file, or the
    newest ``*.json`` under a directory). Returns::

        {"steps": [{"label", "busy_s", "period_s", "idle_share", "events"}, ...],
         "window_s", "busy_s", "idle_share", "launches": {kernel name: count},
         "device_time": {name: {"category", "count", "seconds"}},
         "unattributed": device events of no marked step,
         "launch_lead_s": the least time from a runtime call to the start of
                          a device event it launched (None without one)}

    ``launches`` counts the kernels of the marked steps; ``device_time``
    holds every device event of the marked steps (kernels, copies and
    memsets; ``category`` is the trace's) by name, with the sum of their
    durations. Events that overlap are each counted whole there, so its sum
    is at least the busy time."""
    with open(_newest_trace(path)) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    # the host's ranges (the device timeline repeats each as a gpu_user_annotation)
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(STEP_PREFIX)]
    spans.sort(key=lambda e: float(e["ts"]))
    launches_at = {}  # correlation id -> host timestamp of its runtime call
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches_at[e["args"]["correlation"]] = float(e["ts"])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    steps = [{"label": s["name"][len(STEP_PREFIX):], "events": []} for s in spans]
    bounds = [(float(s["ts"]), float(s["ts"]) + float(s.get("dur", 0.0))) for s in spans]
    unattributed = 0
    lead = None
    for e in device:
        at = launches_at.get(e.get("args", {}).get("correlation"))
        if at is not None:
            lead = float(e["ts"]) - at if lead is None else min(lead, float(e["ts"]) - at)
        owner = None if at is None else next((i for i, (a, b) in enumerate(bounds) if a <= at <= b), None)
        if owner is None:
            unattributed += 1
        else:
            steps[owner]["events"].append(e)
    firsts = [min((float(e["ts"]) for e in s["events"]), default=None) for s in steps]
    launches: dict[str, int] = {}
    device_time: dict[str, dict] = {}
    intervals = []
    for i, step in enumerate(steps):
        own = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in step["events"]]
        intervals += own
        for e in step["events"]:
            if e.get("cat") == "kernel":
                launches[e["name"]] = launches.get(e["name"], 0) + 1
            entry = device_time.setdefault(e["name"], {"category": e["cat"], "count": 0, "seconds": 0.0})
            entry["count"] += 1
            entry["seconds"] += float(e.get("dur", 0.0)) / 1e6
        later = [t for t in firsts[i + 1:] if t is not None]
        end = later[0] if later else max((b for _, b in own), default=firsts[i])
        period = (end - firsts[i]) / 1e6 if firsts[i] is not None else 0.0
        busy = _union_seconds(own)
        step.update(busy_s=busy, period_s=period, idle_share=1.0 - busy / period if period > 0 else 0.0,
                    events=len(own))
    starts = [t for t in firsts if t is not None]
    window = (max(b for _, b in intervals) - min(starts)) / 1e6 if intervals else 0.0
    busy = _union_seconds(intervals)
    return {"steps": steps, "window_s": window, "busy_s": busy,
            "idle_share": 1.0 - busy / window if window > 0 else 0.0,
            "launches": launches, "device_time": device_time, "unattributed": unattributed,
            "launch_lead_s": None if lead is None else lead / 1e6}
