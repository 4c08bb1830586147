"""Spans of the program's layers and ranges of its host work, named
``odtt.<name>``; the layers below the trainer (models, data) mark their work
with them, and ``train/profiler.py`` reads the ranges out of a trace.

* :func:`span` marks a layer's work (``EpochRunner``'s step, the step
  core's forward, match, criterion, backward and update, the model's
  backbone, encoder, mini-detector and decoder). With a
  :class:`SpanRecorder` active it stamps the device's clock at the span's
  start and end into the recorder's buffer, from inside the stream's work,
  so the stamps are captured into a CUDA graph with the step and written
  again by every replay (``ops/cuda/span_stamp.py``); while a
  ``torch.profiler`` records it also opens a ``record_function`` range.
  With neither it returns one shared null context.
* :func:`split_at_grad` cuts a segmented span where the backward reaches a
  tensor's gradient.
* :func:`host_range` marks the program's own host work between steps (the
  epoch runner's index upload, each step's enqueue, the metrics read; the
  device cache's epoch index). It opens a range only while a profiler
  records: the idle gaps of a trace then carry the program's names.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..ops.cuda.span_stamp import span_stamp

__all__ = ["SPAN_PREFIX", "SpanRecorder", "active_recorder", "host_range", "recording", "span", "split_at_grad"]

SPAN_PREFIX = "odtt."  # the name of a span's or host range's record_function range: prefix + name

_NULL = contextlib.nullcontext()
# the recorder spans stamp into: one for the process, not a thread's, since
# autograd's engine runs the backward (and the gradient hooks) on a thread
# of its own
_active: Optional["SpanRecorder"] = None


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class SpanRecorder:
    """Device spans of a step, stamped on the device's own clock.

    ``stamps`` is a preallocated ``(rows, columns)`` int64 buffer of
    nanosecond timestamps on ``device``; each stamp writes column k of row
    ``slot[0]``, ``slot`` a device int64 tensor (the epoch runner points it
    at its metrics slot, so that each replay of a captured step writes its
    own row). Each span has a start and an end boundary, each boundary a
    column, assigned in the order of first use: a step that opens the same
    spans in the same order writes the same columns every time, and a
    captured graph writes them in every replay. On a CUDA device a stamp is
    one launch of ``ops/cuda/span_stamp.py``'s kernel (``%globaltimer``) on
    the current stream, with no host sync; on the CPU it writes
    ``time.perf_counter_ns()``.

    A span opened with ``first=`` is cut into segments, its children: the
    first begins at the span's start, :meth:`split` ends the current one
    and begins the next at one boundary (gradient hooks inside the
    backward, :func:`split_at_grad`), and the last ends with the span.

    Activate it with :func:`recording`; :meth:`read` copies the stamps to
    the host once. ``steps`` maps a row to the step that wrote it, where the
    caller labelled it (the epoch runner does)."""

    COLUMNS = 64  # boundaries a step may stamp

    def __init__(self, device, rows: int):
        self.device = torch.device(device)
        self.stamps = torch.zeros((rows, self.COLUMNS), dtype=torch.int64, device=self.device)
        self.slot = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.steps: dict[int, int] = {}
        self.parent: dict[str, Optional[str]] = {}  # span -> the span it opened inside, in order of first use
        self._columns: dict[str, tuple[int, int]] = {}  # span -> (start column, end column)
        self._boundaries: dict[tuple[str, str], int] = {}  # (span, "start" / "end") -> column
        self._open: list[list] = []  # [name, open segment or None, its start column], innermost last

    def _boundary(self, name: str, edge: str) -> int:
        key = (name, edge)
        if key not in self._boundaries:
            if len(self._boundaries) == self.stamps.shape[1]:
                raise ValueError(f"more than {self.stamps.shape[1]} span boundaries")
            self._boundaries[key] = len(self._boundaries)
        return self._boundaries[key]

    def _declare(self, name: str, parent: Optional[str]) -> None:
        if self.parent.setdefault(name, parent) != parent:
            raise ValueError(f"span {name!r} opened inside {parent!r}, first inside {self.parent[name]!r}")

    def _span(self, name: str, start: int, end: int) -> None:
        if self._columns.setdefault(name, (start, end)) != (start, end):
            raise ValueError(f"span {name!r} stamped into other columns than at its first use")

    def open(self, name: str, first: Optional[str] = None) -> None:
        self._declare(name, self._open[-1][0] if self._open else None)
        start = self._boundary(name, "start")
        span_stamp(self.stamps, self.slot, start)
        self._open.append([name, first, start])
        if first is not None:
            self._declare(first, name)

    def split(self, name: str) -> None:
        """End the innermost open span's current segment and begin its
        segment ``name``, at one boundary. Nothing where the innermost open
        span has no segments."""
        if not self._open or self._open[-1][1] is None:
            return
        entry = self._open[-1]
        column = self._boundary(name, "start")
        span_stamp(self.stamps, self.slot, column)
        self._span(entry[1], entry[2], column)
        self._declare(name, entry[0])
        entry[1], entry[2] = name, column

    def close(self) -> None:
        name, segment, segment_start = self._open.pop()
        end = self._boundary(name, "end")
        span_stamp(self.stamps, self.slot, end)
        self._span(name, self._boundaries[(name, "start")], end)
        if segment is not None:
            self._span(segment, segment_start, end)

    def read(self, n: int) -> list[dict]:
        """Rows ``0 .. n-1`` in one copy to the host: for each, ``{"step":
        the step that wrote it (the row where unlabelled), "spans": {name:
        {"ms", "self_ms", "parent"}}}``, the spans in order of first use.
        ``ms`` is the span's duration; ``self_ms`` the duration less the part
        of it that its children's intervals cover."""
        stamps = self.stamps[:n].cpu().tolist()
        names = [name for name in self.parent if name in self._columns]
        children = {name: [c for c in names if self.parent[c] == name] for name in names}
        out = []
        for row, ns in enumerate(stamps):
            interval = {name: (ns[a], ns[b]) for name, (a, b) in self._columns.items()}
            spans = {}
            for name in names:
                a, b = interval[name]
                covered = [(max(a, interval[c][0]), min(b, interval[c][1])) for c in children[name]]
                covered_ms = _union_ns([(x, y) for x, y in covered if y > x]) / 1e6
                spans[name] = {"ms": (b - a) / 1e6, "self_ms": (b - a) / 1e6 - covered_ms,
                               "parent": self.parent[name]}
            out.append({"step": self.steps.get(row, row), "spans": spans})
        return out


class _Span:
    __slots__ = ("recorder", "name", "first", "range")

    def __init__(self, recorder, name, first):
        self.recorder, self.name, self.first = recorder, name, first
        self.range = torch.profiler.record_function(SPAN_PREFIX + name) if _profiling() else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.recorder is not None:
            self.recorder.open(self.name, self.first)

    def __exit__(self, *exc):
        if self.recorder is not None:
            self.recorder.close()
        if self.range is not None:
            self.range.__exit__(*exc)


def span(name: str, first: Optional[str] = None) -> contextlib.AbstractContextManager:
    """The span ``name`` around a layer's work (see :class:`SpanRecorder`;
    ``first``: the name of its first segment). With no recorder active and
    no profiler recording, the shared null context."""
    if _active is None and not _profiling():
        return _NULL
    return _Span(_active, name, first)


def split_at_grad(tensor: torch.Tensor, name: str) -> None:
    """Where a recorder is active and ``tensor`` takes a gradient: when the
    backward has computed ``tensor``'s gradient, the open segmented span's
    segment ``name`` begins (:meth:`SpanRecorder.split`). The hook is
    registered only then, so a step without a recorder is unchanged."""
    recorder = _active
    if recorder is not None and tensor.requires_grad:
        tensor.register_hook(lambda grad: recorder.split(name))


def host_range(name: str) -> contextlib.AbstractContextManager:
    """The range ``odtt.<name>`` around the program's host work while a
    profiler records; the shared null context otherwise."""
    return torch.profiler.record_function(SPAN_PREFIX + name) if _profiling() else _NULL


@contextlib.contextmanager
def recording(recorder: SpanRecorder):
    """Spans stamp into ``recorder`` inside the ``with``."""
    global _active
    if _active is not None:
        raise RuntimeError("a span recorder is active already")
    _active = recorder
    try:
        yield recorder
    finally:
        _active = None


def active_recorder() -> Optional[SpanRecorder]:
    return _active


def _union_ns(intervals: list[tuple[int, int]]) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is not None and b <= end:
            continue
        total += b - (a if end is None else max(a, end))
        end = b
    return total
