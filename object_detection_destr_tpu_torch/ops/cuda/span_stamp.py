"""One timestamp of a device span: the hand-written CUDA kernel of
``csrc/span_stamp.cu``, its ctypes binding, and its plain version.

``span_stamp(stamps, slot, column)`` writes the time into
``stamps[slot[0], column]``. On a CUDA tensor the kernel reads the device's
nanosecond clock (``%globaltimer``) when the current stream reaches it, with
no host sync, and reads ``slot`` on the device, so a CUDA graph that
captured it writes the row the host set before each replay
(``runtime/spans.py::SpanRecorder``). On a CPU tensor the plain version
writes ``time.perf_counter_ns()``. The library is built at the first stamp.
"""

from __future__ import annotations

import ctypes
import time

import torch

from .build import CudaLibrary, LaunchCounter

__all__ = ["SpanStamp", "span_stamp", "span_stamp_kernel", "span_stamp_reference"]

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "odtt_span_stamp", "span_stamp.cu",
    functions={"odtt_span_stamp": (_I, [_P, _P, _I, _I, _I, _P])},
    abi=("odtt_span_stamp_abi_version", 1),
)


def _check(stamps: torch.Tensor, slot: torch.Tensor, column: int) -> None:
    if stamps.dim() != 2 or stamps.dtype != torch.int64 or not stamps.is_contiguous():
        raise ValueError(f"span_stamp takes contiguous int64 stamps (rows, columns), got {stamps.dtype} "
                         f"{tuple(stamps.shape)}")
    if slot.numel() != 1 or slot.dtype != torch.int64 or slot.device != stamps.device:
        raise ValueError("span_stamp takes one int64 slot on the stamps' device")
    if not 0 <= column < stamps.shape[1]:
        raise ValueError(f"column {column} outside the stamps' {stamps.shape[1]}")


def span_stamp_reference(stamps: torch.Tensor, slot: torch.Tensor, column: int) -> None:
    """The kernel's function on the host's clock: ``stamps[slot, column] =
    time.perf_counter_ns()`` (a slot outside the rows writes nothing)."""
    _check(stamps, slot, column)
    row = int(slot.reshape(()))
    if 0 <= row < stamps.shape[0]:
        stamps[row, column] = time.perf_counter_ns()


class SpanStamp(LaunchCounter):
    """The kernel's wrapper: checks the operands and launches one thread on
    the current stream. ``launches`` counts kernel launches and nothing
    else."""

    library = LIBRARY

    def __call__(self, stamps: torch.Tensor, slot: torch.Tensor, column: int) -> None:
        _check(stamps, slot, column)
        if not stamps.is_cuda:
            raise ValueError("span_stamp_kernel: the stamps must be on a CUDA device")
        lib = self.library.library()
        with torch.cuda.device(stamps.device):
            stream = torch.cuda.current_stream(stamps.device).cuda_stream
            err = lib.odtt_span_stamp(stamps.data_ptr(), slot.data_ptr(), stamps.shape[0], stamps.shape[1],
                                      int(column), stream)
        if err != 0:
            raise RuntimeError(f"span_stamp launch failed: CUDA error {err}")
        self.count_launch(stream)


span_stamp_kernel = SpanStamp()


def span_stamp(stamps: torch.Tensor, slot: torch.Tensor, column: int) -> None:
    """The kernel for CUDA tensors, its plain version for CPU ones."""
    fn = span_stamp_kernel if stamps.is_cuda else span_stamp_reference
    fn(stamps, slot, column)
