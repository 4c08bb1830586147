"""The trace parser of train/profiler.py on a small Chrome trace written
here, shaped as ``torch.profiler``'s export on a GPU is (host ranges of
``record_function``, runtime calls with a ``correlation`` id, device events
of category kernel / gpu_memcpy / gpu_memset carrying the same id; a CUDA
graph's replay is one ``cudaGraphLaunch`` whose kernels all carry its id),
and a real CPU trace through :class:`StepTrace`.

The fixture's numbers are chosen so that each result is known by hand:
step 7 launches two kernels that overlap (busy = their union) and a memcpy;
step 8 is one graph replay of three kernels; one kernel launched after the
steps and one whose launch the trace lacks (though it runs during step 7)
belong to no step.
"""

import json

import pytest
import torch

from object_detection_destr_tpu_torch.runtime.spans import SPAN_PREFIX
from object_detection_destr_tpu_torch.train.profiler import (
    STEP_PREFIX,
    StepTimer,
    StepTrace,
    parse_trace,
)
from torch_threads import one_torch_thread  # noqa: F401


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _fixture():
    k = lambda name, ts, dur, corr: _x("kernel", name, ts, dur, pid=0, tid=7, correlation=corr)
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python3"}},
        _x("user_annotation", STEP_PREFIX + "7", 1000.0, 300.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1010.0, 5.0, correlation=11),
        _x("cuda_runtime", "cudaLaunchKernel", 1020.0, 5.0, correlation=12),
        _x("cuda_runtime", "cudaMemcpyAsync", 1030.0, 5.0, correlation=13),
        _x("user_annotation", STEP_PREFIX + "8", 1400.0, 50.0),
        _x("cuda_runtime", "cudaGraphLaunch", 1410.0, 10.0, correlation=21),
        _x("cuda_runtime", "cudaLaunchKernel", 2000.0, 5.0, correlation=31),  # after the steps
        _x("gpu_user_annotation", STEP_PREFIX + "8", 1500.0, 300.0, pid=0, tid=7),  # the device's copy of a range
        k("void flash_fwd_tc_kernel<1, 32>(...)", 1100.0, 40.0, 11),
        k("fused_auction_kernel", 1120.0, 40.0, 12),  # overlaps: union 1100-1160
        _x("gpu_memcpy", "Memcpy HtoD", 1200.0, 20.0, pid=0, tid=7, correlation=13),
        k("void flash_fwd_tc_kernel<1, 32>(...)", 1500.0, 100.0, 21),
        k("void flash_bwd_tc_kernel<32, 1, 64>(...)", 1600.0, 100.0, 21),
        k("fused_auction_kernel", 1750.0, 50.0, 21),
        k("void flash_fwd_tc_kernel<1, 32>(...)", 2100.0, 10.0, 31),
        k("no launch in the trace", 1300.0, 10.0, 99),
    ]}


def test_parse_trace_fixture(tmp_path):
    path = tmp_path / "trace_fixture.json"
    path.write_text(json.dumps(_fixture()))
    out = parse_trace(str(tmp_path))  # the newest *.json under a directory
    assert [s["label"] for s in out["steps"]] == ["7", "8"]
    first, second = out["steps"]
    assert first["events"] == 3 and second["events"] == 3
    assert first["busy_s"] == pytest.approx(80e-6)  # 1100-1160 and 1200-1220
    assert first["period_s"] == pytest.approx(400e-6)  # to step 8's first device event
    assert first["idle_share"] == pytest.approx(0.8)
    assert second["busy_s"] == pytest.approx(250e-6) and second["period_s"] == pytest.approx(300e-6)
    assert out["window_s"] == pytest.approx(700e-6) and out["busy_s"] == pytest.approx(330e-6)
    assert out["idle_share"] == pytest.approx(1 - 330 / 700)
    assert out["launches"] == {"void flash_fwd_tc_kernel<1, 32>(...)": 2, "fused_auction_kernel": 2,
                               "void flash_bwd_tc_kernel<32, 1, 64>(...)": 1}
    assert out["unattributed"] == 2
    assert parse_trace(str(path))["steps"][1]["label"] == "8"  # a file as well as a directory


def test_parse_trace_spans(tmp_path):
    """The same trace with the program's ``odtt.`` ranges: each device event
    of a marked step goes to the innermost range that holds its launch;
    events launched outside every range, or in no marked step, to none."""
    trace = _fixture()
    trace["traceEvents"] += [
        _x("user_annotation", SPAN_PREFIX + "step", 1002.0, 290.0),
        _x("user_annotation", SPAN_PREFIX + "forward", 1005.0, 10.0),  # holds launch 11
        _x("user_annotation", SPAN_PREFIX + "backward", 1018.0, 20.0),  # holds 12 and the memcpy's 13
        _x("user_annotation", SPAN_PREFIX + "enqueue", 1405.0, 20.0),  # holds the graph launch 21
        _x("user_annotation", SPAN_PREFIX + "metrics_read", 1990.0, 20.0),  # 31: after the steps
    ]
    path = tmp_path / "trace_spans.json"
    path.write_text(json.dumps(trace))
    out = parse_trace(str(path))
    assert out["spans"] == pytest.approx({"forward": 40e-6, "backward": 60e-6, "enqueue": 250e-6})
    assert out["span_families"]["backward"] == pytest.approx({"fused_auction #9": 40e-6, "copies and memsets": 20e-6})
    assert out["span_families"]["enqueue"] == pytest.approx(
        {"flash_attention_fwd #1/#5": 100e-6, "flash_attention_bwd #2": 100e-6, "fused_auction #9": 50e-6})
    assert out["steps"][0]["busy_s"] == pytest.approx(80e-6) and out["unattributed"] == 2  # the steps as before


def test_step_trace_on_the_cpu(tmp_path):
    """A CPU trace exports, and its marked steps parse (no device events)."""
    trace = StepTrace(str(tmp_path))
    trace.start()
    for step in range(3):
        with trace.step(step):
            torch.ones(8).sum()
    path = trace.stop()
    out = parse_trace(str(tmp_path))
    assert [s["label"] for s in out["steps"]] == ["0", "1", "2"]
    assert out["busy_s"] == 0.0 and out["launches"] == {}
    assert parse_trace(path)["steps"] == out["steps"]  # stop() returns the exported file


def test_step_timer_counts_steps():
    timer = StepTimer(batch_size=4, device=torch.device("cpu"))
    timer.start()
    for _ in range(3):
        timer.step()
    rate = timer.stop()
    assert rate["images_per_sec"] == pytest.approx(4 * rate["steps_per_sec"]) and timer.step_ms == []
