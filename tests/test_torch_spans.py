"""Device spans of the training step (runtime/spans.py: ``SpanRecorder``,
``span``, ``split_at_grad``, ``host_range``; the stamp kernel of
ops/cuda/span_stamp.py) and the benchmark's readers of them
(port_bench/harness/spans.py, port_bench/metrics/*_ms.train.py).

On the CPU a stamp writes the host's clock into the recorder's buffer, so
these tests exercise the rows, the span tree and its arithmetic; the test
marked ``card`` captures a step with a recorder on a CUDA device and holds
the replays' stamps (it skips without one)."""

import sys
import time
import types

import numpy as np
import pytest
import torch
from torch import nn

from object_detection_destr_tpu_torch.models.destr.layers import DropoutRng
from object_detection_destr_tpu_torch.ops.cuda.span_stamp import span_stamp_kernel
from object_detection_destr_tpu_torch.runtime import spans as runtime_spans
from object_detection_destr_tpu_torch.runtime.spans import SpanRecorder, host_range, recording, span, split_at_grad
from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner
from object_detection_destr_tpu_torch.train.state import TrainState
from port_bench.harness import registry
from port_bench.harness import spans as bench_spans
from port_bench.harness.coco_tree import write_coco_tree
from port_bench.tests.tiny import tiny_cell
from torch_threads import one_torch_thread  # noqa: F401

# the spans of a DESTR step in the epoch runner, by parent, in order
DESTR_SPANS = {
    "step": None, "augment": "step", "forward": "step", "backbone": "forward", "encoder": "forward",
    "mini_detector": "forward", "decoder": "forward", "match": "step", "criterion": "step", "backward": "step",
    "backward.heads": "backward", "backward.encoder": "backward", "backward.backbone": "backward",
    "update": "step", "ema": "step", "metrics": "step",
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_without_a_recorder_a_span_is_the_shared_null_context():
    launches = span_stamp_kernel.launches
    assert runtime_spans.active_recorder() is None
    assert span("forward") is span("backward", first="backward.heads") is host_range("enqueue")
    x = torch.ones(3, requires_grad=True) * 2
    split_at_grad(x, "backward.encoder")  # no recorder: no hook
    assert not x._backward_hooks
    with span("step"), span("forward"):
        x.sum().backward()
    assert span_stamp_kernel.launches == launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("forward"), host_range("enqueue"):  # a profiler records: ranges, no stamps
            torch.ones(2).sum()
    names = {e.name for e in prof.events()}
    assert {"odtt.forward", "odtt.enqueue"} <= names and span_stamp_kernel.launches == launches


def test_nested_spans_self_time_parents_and_columns(monkeypatch):
    """Stamps from a clock that advances 10 ns a read: each duration and
    self time is known by hand."""
    clock = iter(range(0, 10**6, 10))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock))
    rec = SpanRecorder("cpu", 3)
    with recording(rec):
        with pytest.raises(RuntimeError, match="active already"):
            with recording(SpanRecorder("cpu", 1)):
                pass
        for row in range(3):
            rec.slot.fill_(row)
            rec.steps[row] = 40 + row
            with span("step"):  # t0
                with span("a"):  # t1 .. t2
                    pass
                with span("b", first="b.1"):  # t3; b.1 from t3
                    rec.split("b.2")  # t4: b.1 ends, b.2 begins
                    rec.split("b.3")  # t5
                # t6: b and b.3 end
            # t7
    assert runtime_spans.active_recorder() is None
    rows = rec.read(3)
    assert [r["step"] for r in rows] == [40, 41, 42]
    ticks = lambda n: n * 10 / 1e6  # ms
    for r in rows:
        s = r["spans"]
        assert list(s) == ["step", "a", "b", "b.1", "b.2", "b.3"]
        assert {k: v["parent"] for k, v in s.items()} == {"step": None, "a": "step", "b": "step", "b.1": "b",
                                                          "b.2": "b", "b.3": "b"}
        assert s["step"]["ms"] == pytest.approx(ticks(7)) and s["a"]["ms"] == pytest.approx(ticks(1))
        assert s["b"]["ms"] == pytest.approx(ticks(3)) and s["b"]["self_ms"] == pytest.approx(0.0)
        assert [s[k]["ms"] for k in ("b.1", "b.2", "b.3")] == pytest.approx([ticks(1)] * 3)
        # the step less a (t1-t2) and b (t3-t6): t0-t1, t2-t3, t6-t7
        assert s["step"]["self_ms"] == pytest.approx(ticks(3))
    stamps = rec.stamps.tolist()
    assert all(row[:8] == sorted(row[:8]) and row[8:] == [0] * 56 for row in stamps)  # 8 columns a row, in order
    assert stamps[1][0] == stamps[0][7] + 10  # each row its own
    rec.slot.fill_(0)
    with recording(rec), span("step"), pytest.raises(ValueError, match="first inside"):
        with span("b"), span("a"):  # a inside b, first inside the step
            pass


def _destr_run(tmp_path, recorder, steps):
    """``steps`` steps of the benchmark's tiny DESTR cell through the epoch
    runner on the CPU (port_bench's set-up, over its tiny COCO tree), under
    ``recorder`` where given: (metrics, parameters)."""
    cell = tiny_cell("train-coco-800")
    root = str(tmp_path / "coco")
    write_coco_tree(root, 7, cell.params["images"], sizes=[tuple(hw) for hw in cell.params["sizes"]])
    ctx = types.SimpleNamespace(cell=cell, seed=7, log=lambda message: None)
    runner, cache, state = registry.load_generator(cell.generator)._program(ctx, root, torch.device("cpu"))
    _, idx = cache.epoch_index_matrix()
    if recorder is None:
        metrics = runner.run(idx[:steps], 0)
    else:
        with recording(recorder):
            metrics = runner.run(idx[:steps], 0)
    return metrics, [p.detach() for p in state.model.parameters()]


def test_epoch_runner_with_a_recorder_is_the_plain_run(tmp_path):
    """The tiny DESTR on the CPU: the same metrics and parameters bit for
    bit with and without a recorder, and a row a step of every span,
    ``backward``'s segments from the model's gradient hooks included, each
    span inside its parent."""
    steps = 2
    plain, plain_params = _destr_run(tmp_path, None, steps)
    rec = SpanRecorder("cpu", steps)
    traced, traced_params = _destr_run(tmp_path, rec, steps)
    assert plain.keys() == traced.keys() and all(np.array_equal(plain[k], traced[k]) for k in plain)
    assert all(torch.equal(a, b) for a, b in zip(plain_params, traced_params))
    rows = rec.read(steps)
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        s = r["spans"]
        assert {k: v["parent"] for k, v in s.items()} == DESTR_SPANS
        assert all(v["ms"] > 0 and -1e-9 <= v["self_ms"] <= v["ms"] for v in s.values())
        assert s["backward"]["self_ms"] == pytest.approx(0.0, abs=1e-9)  # its segments tile it
        top = sum(s[k]["ms"] for k, parent in DESTR_SPANS.items() if parent == "step")
        assert top == pytest.approx(s["step"]["ms"] - s["step"]["self_ms"])


RUN_SPANS = {
    "steps": 32,
    "ms": {"step": 73.0, "augment": 1.5, "forward": 20.0, "backbone": 9.0, "encoder": 4.0, "mini_detector": 2.0,
           "decoder": 4.5, "match": 0.25, "criterion": 3.0, "backward": 40.0, "backward.heads": 12.0,
           "backward.encoder": 8.0, "backward.backbone": 20.0, "update": 6.0, "ema": 1.25, "metrics": 0.5},
}


@pytest.mark.parametrize("metric, want", [
    ("augment_ms.train", 1.5), ("backbone_ms.train", 29.0), ("transformer_ms.train", 30.5),
    ("matcher_ms.train", 0.25), ("criterion_ms.train", 3.0), ("update_ms.train", 7.25),
])
def test_the_span_readers(metric, want):
    reader = registry.load_reader(metric)
    assert reader.read({"spans": RUN_SPANS}) == pytest.approx(want)
    assert reader.read({}) is None  # no trace: no stretch, nothing to read
    assert reader.read({"spans": None}) is None  # a program without spans
    lacking = {"spans": {"ms": {k: v for k, v in RUN_SPANS["ms"].items() if not k.startswith("backward.")}}}
    assert (reader.read(lacking) is None) == any(s.startswith("backward.") for s in reader.SPANS)


def test_the_stretch_summary():
    row = lambda ms: {"step": 0, "spans": {"step": {"ms": ms, "self_ms": ms / 4, "parent": None},
                                           "update": {"ms": ms / 2, "self_ms": ms / 2, "parent": "step"}}}
    out = bench_spans.summarize([row(70.0), row(74.0), row(72.0)])
    assert out == {"steps": 3, "ms": {"step": 72.0, "update": 36.0}, "self_ms": {"step": 18.0, "update": 36.0},
                   "parent": {"step": None, "update": "step"}}


class _Toy(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.a = nn.Linear(width, width)
        self.b = nn.Linear(width, width)


def _toy_core(state, batch):
    """Forward, loss, backward in two segments (the hook on the first
    layer's output), an SGD update: each in its span."""
    model = state.model
    with span("forward"):
        h = model.a(batch["x"])
        split_at_grad(h, "backward.a")
        out = model.b(torch.relu(h))
    with span("criterion"):
        loss = out.square().mean()
    with span("backward", first="backward.b"):
        loss.backward()
    with span("update"), torch.no_grad():
        for p in model.parameters():
            p.sub_(1e-6 * p.grad)
            p.grad = None
    return {"loss": loss.detach()}


# the spans of the toy step, by parent
TOY_SPANS = {"step": None, "augment": "step", "forward": "step", "criterion": "step", "backward": "step",
             "backward.b": "backward", "backward.a": "backward", "update": "step", "metrics": "step"}


def _toy_runner(device, width, rows, batch):
    """An epoch runner of the toy step over ``rows`` rows of (``batch``,
    ``width``) inputs."""
    torch.manual_seed(0)
    data = {"x": torch.randn(rows, 4, width, device=device)}
    state = TrainState(model=_Toy(width).to(device), optimizer=None, rng=DropoutRng(4, device))
    return EpochRunner(state, _toy_core, lambda raw, generator: {"x": raw["x"] * 1.0}, data, lambda step: step,
                       steps_per_epoch=rows // batch)


class _ToyCache:
    """The device cache's epoch index, for the toy runner."""

    def __init__(self, steps, batch):
        self.steps, self.batch = steps, batch

    def epoch_index_matrix(self):
        return 0, np.arange(self.steps * self.batch, dtype=np.int64).reshape(self.steps, self.batch) % self.steps

    def advance_epoch(self):
        pass


def test_the_stretch_rounds(tmp_path, monkeypatch):
    """On the CPU, the toy step in place of the cell's program: rounds run
    until one agrees with the traced steps' busy time, at most ``ROUNDS``,
    and the round closest to it gives the metrics; a program without the
    span module gives None; a stretch that fails fails the read."""
    cell = tiny_cell("train-coco-800")
    root = str(tmp_path / "coco")
    cpu = torch.device("cpu")
    program = (_toy_runner(cpu, 4, 8, 2), _ToyCache(4, 2), None)
    monkeypatch.setattr(registry, "load_cell", lambda name: cell)
    monkeypatch.setattr(registry, "load_generator", lambda name: types.SimpleNamespace(_program=lambda *a: program))
    monkeypatch.setattr(bench_spans, "STEPS", 2)
    monkeypatch.setattr(bench_spans, "ROUNDS", 2)
    run = {"cell": cell.name, "tree": root, "trace": {"busy_s": 1e3, "steps": 1}, "images": 8, "window_s": 1.0}
    far = bench_spans.stretch(run, 7)  # a busy time of 1000 s a step: no round agrees
    assert len(far["rounds_step_ms"]) == 2 and not far["agrees"]
    assert far["ms"]["step"] == max(far["rounds_step_ms"]) and far["round"] == far["rounds_step_ms"].index(
        far["ms"]["step"])
    assert set(far["ms"]) == set(TOY_SPANS) and far["busy_ms"] == 1e6
    monkeypatch.setattr(bench_spans, "AGREE", 1e9)
    near = bench_spans.stretch(run, 7)  # the first round agrees
    assert len(near["rounds_step_ms"]) == 1 and near["agrees"] and near["round"] == 0
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "object_detection_destr_tpu_torch.runtime.spans", None)
        assert bench_spans.stretch(run, 7) is None  # the parent's program: no spans, nothing read

    def broken(*args):
        raise RuntimeError("the stamp failed")

    monkeypatch.setattr(registry, "load_generator", lambda name: types.SimpleNamespace(_program=broken))
    monkeypatch.setattr(bench_spans, "_seed", lambda: 7)
    with pytest.raises(RuntimeError, match="the stamp failed"):
        registry.load_reader("matcher_ms.train").read(run)


@pytest.mark.card
def test_spans_in_the_captured_step_on_the_card(card):
    width, tokens, batch = 1024, 4096, 4
    data = {"x": torch.randn(4 * batch, tokens, width, device=card)}
    idx = np.arange(4 * batch, dtype=np.int64).reshape(4, batch)
    transform = lambda raw, generator: {"x": raw["x"] * 1.0}

    def runner():
        torch.manual_seed(0)
        state = TrainState(model=_Toy(width).to(card), optimizer=None, rng=DropoutRng(4, card))
        return EpochRunner(state, _toy_core, transform, data, lambda step: step, steps_per_epoch=8)

    before = span_stamp_kernel.launches
    plain = runner()
    plain.run(idx[:3], 0)  # eager, capture, replay: no recorder, no stamp
    assert plain.graph is not None and span_stamp_kernel.launches == before

    rec = SpanRecorder(card, 4)
    traced = runner()
    with recording(rec):
        traced.run(idx[:1], 0)  # eager (stamps) and capture (stamps captured)
        launches = span_stamp_kernel.launches
        traced.run(np.concatenate([idx[1:], idx[:1]]), 1)  # 4 replays, rows 0-3
    assert span_stamp_kernel.launches == launches  # a replay calls no wrapper
    torch.cuda.synchronize()
    columns = sorted(set(rec._boundaries.values()))
    stamps = rec.stamps[:, columns].cpu()
    assert (stamps > 0).all() and (stamps.diff(dim=1) >= 0).all()  # in span order, each row
    assert (stamps[1:, 0] > stamps[:-1, -1]).all()  # each replay its own row, after the one before
    for r in rec.read(4):
        s = r["spans"]
        assert set(s) == {"step", "augment", "forward", "criterion", "backward", "backward.b", "backward.a",
                          "update", "metrics"}
        assert s["backward.a"]["ms"] > 0 and s["backward.b"]["ms"] > 0  # the hook's stamp inside the backward
        children = sum(v["ms"] for v in s.values() if v["parent"] == "step")
        assert children == pytest.approx(s["step"]["ms"], rel=0.02), s
