"""The traced window: a ``torch.profiler`` trace opened and closed by the
harness, and its reduction to device busy time, the window, kernel time by
name and by family, and the longest idle gaps.

The arithmetic is a copy of the port's:
``object_detection_destr_tpu_torch/train/profiler.py`` l.131-214
(``_union_seconds``; ``parse_trace``'s busy time as the union of the device
events' intervals and its window from the first event to the last, here
over every device event of the trace, which the harness opens around the
measured window alone) and ``tools/profile_step_torch.py`` l.34-59
(``category``: the port's kernels, cuDNN's convolutions, GEMM, copies, and
everything else as elementwise / reduction). The harness names each step
with a ``record_function`` range, which the idle gaps' labels show."""

from __future__ import annotations

import contextlib
import json
import os
import re
import time

import torch

__all__ = ["Trace", "parse_trace", "category", "breakdown", "family_seconds", "RANGE_PREFIX"]

RANGE_PREFIX = "port_bench "  # a range the harness names
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")

PORT_KERNELS = (
    ("flash_attention_fwd #1/#5", r"flash_fwd_(tc|f32)_kernel"),
    ("flash_attention_bwd #2", r"flash_bwd_(tc|f32)_kernel"),
    ("flash_attention_dq #3/#6", r"flash_two_pass_(tc|f32)(_wide)?_kernel(<false|ILb0E)"),
    ("flash_attention_dkv #4/#7", r"flash_two_pass_(tc|f32)(_wide)?_kernel(<true|ILb1E)"),
    ("fused_auction #9", r"fused_auction_kernel"),
    ("auction_kernel #8", r"(?<!fused_)auction_kernel"),
)
LIBRARY_KERNELS = (
    ("convolution", r"conv|fprop|dgrad|wgrad|implicit_gemm|nchwToNhwc|nhwcToNchw|cudnn"),
    ("GEMM", r"gemm|gemv|nvjet|cutlass|cublas|splitK"),
)
COPIES = "copies and memsets"
OTHER = "elementwise / reduction"
FLASH = r"flash_(fwd|bwd|two_pass)_"  # every flash kernel of the port (#1-#7)


def category(name: str, trace_category: str) -> str:
    """The family of one device event."""
    if trace_category in ("gpu_memcpy", "gpu_memset"):
        return COPIES
    for label, pattern in PORT_KERNELS + LIBRARY_KERNELS:
        if re.search(pattern, name):
            return label
    return OTHER


class Trace:
    """A profiler window: ``start()`` before the traced work, ``range(label)``
    around each step on the host, ``stop()`` after it (waits for the device).
    A first profiler is started and stopped when the object is made, so
    that CUPTI's start-up cost stays out of the traced window. The window
    stays open ``MARGIN_S`` on each side with the device idle: the profiler
    keeps only the device events whose time, on the host's clock, lies in
    its window, and the two clocks disagree by milliseconds."""

    MARGIN_S = 0.25

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self._prof = None
        # device events and CUDA runtime calls, and the host's operators and ranges
        activities = [torch.profiler.ProfilerActivity.CUDA, torch.profiler.ProfilerActivity.CPU]
        warm = torch.profiler.profile(activities=activities)
        warm.start()
        warm.stop()
        self._activities = activities

    def start(self) -> None:
        self._prof = torch.profiler.profile(activities=self._activities)
        self._prof.start()
        torch.cuda.synchronize()
        time.sleep(self.MARGIN_S)

    @staticmethod
    def range(label) -> contextlib.AbstractContextManager:
        return torch.profiler.record_function(f"{RANGE_PREFIX}{label}")

    def stop(self) -> str:
        torch.cuda.synchronize()
        time.sleep(self.MARGIN_S)
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        prof.export_chrome_trace(path)
        return path


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e6


def parse_trace(path: str) -> dict:
    """{"window_s", "busy_s", "idle_share", "device_time": {name:
    {"category", "count", "seconds"}}, "gaps": [(idle seconds, what the host was doing)] longest first}
    over every device event of the trace (kernels, copies, memsets). The
    window runs from the first device event to the end of the last."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    device_time: dict[str, dict] = {}
    intervals = []
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in _DEVICE_CATS:
            start = float(e["ts"])
            intervals.append((start, start + float(e.get("dur", 0.0))))
            entry = device_time.setdefault(e["name"], {"category": cat, "count": 0, "seconds": 0.0})
            entry["count"] += 1
            entry["seconds"] += float(e.get("dur", 0.0)) / 1e6
        elif cat in _HOST_CATS:
            host.append(e)
    window = (max(b for _, b in intervals) - min(a for a, _ in intervals)) / 1e6 if intervals else 0.0
    busy = _union_seconds(intervals)
    return {"window_s": window, "busy_s": busy, "idle_share": 1.0 - busy / window if window > 0 else 0.0,
            "device_time": device_time, "gaps": _idle_gaps(intervals, host)}


def _idle_gaps(intervals: list[tuple[float, float]], host: list[dict], top: int = 10) -> list[tuple[float, str]]:
    """The ``top`` longest gaps between the device's busy intervals, each
    named by the shortest host event (an op, range or runtime call) that
    spans the gap's middle, or "host idle"."""
    gaps, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        around = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e.get("dur", 0.0))]
        name = min(around, key=lambda e: float(e.get("dur", 0.0)))["name"] if around else "host idle"
        named.append(((b - a) / 1e6, str(name)))
    return named


def family_seconds(parsed: dict) -> dict[str, float]:
    """Device seconds of the traced ranges by family (:func:`category`)."""
    out: dict[str, float] = {}
    for name, v in parsed["device_time"].items():
        fam = category(name, v["category"])
        out[fam] = out.get(fam, 0.0) + v["seconds"]
    return out


def breakdown(parsed: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time (by name) and the longest idle gaps by what the host was doing."""
    ops = sorted(parsed["device_time"].items(), key=lambda kv: -kv[1]["seconds"])[:top]
    return {"device_ops": [[name[:200], v["seconds"]] for name, v in ops],
            "idle_gaps": [[what[:200], seconds] for seconds, what in parsed["gaps"][:top]]}
