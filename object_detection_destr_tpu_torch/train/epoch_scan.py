"""Training epochs as CUDA-graph replays (port of
``object_detection_destr_tpu/train/epoch_scan.py``, l.43-111).

With ``--device_cache`` the whole set lives on the device and the train
transform runs there, so a training step needs nothing of the host but its
batch indices and its step number. The JAX package compiles gather ->
augment -> train step -> EMA for a whole epoch into one ``lax.scan``; here
one step of the same body is captured in a ``torch.cuda.CUDAGraph`` and the
graph is replayed once a step, so a step costs the host a few calls instead
of the thousands of kernel launches of the eager step.

Per step the host copies the step's index row and metrics slot into static
tensors, reseeds the dropout and augmentation generators from (seed, step)
(both are registered with the graph, so a replay draws what the eager step
draws at that step), and replays. Each step writes its metrics into slot i
of preallocated (steps,) device buffers, which the host reads once an epoch,
as ``jax.device_get(stacked)`` does.

The body is marked with spans (``runtime/spans.py``): ``step`` around it,
holding ``augment`` (the gather and the transform), the step core's own
(forward, match, criterion, backward, update), ``ema`` and ``metrics``. With
a :class:`~..runtime.spans.SpanRecorder` active when the step is captured, the
graph holds their stamps and each replay writes its step's row (the
recorder's slot is the runner's metrics slot); without one the graph is
the plain step. The host work of ``run`` sits in ``odtt.`` ranges while a
profiler records: ``run`` around the call, holding ``index_upload``,
``enqueue`` for each step and ``metrics_read``.

The first step the runner takes is the warm-up PyTorch asks for before a
capture: the body runs eagerly on a side stream (a real step, counted as
one), then one step is captured (nothing runs) and replayed from the second
step on. On a CUDA device the runner captures or raises; on the CPU it runs
the same body uncaptured, step by step, which is what the CPU tests hold
against the per-step loop.

Over a data-parallel mesh (JAX: one ``shard_map`` over the epoch,
epoch_scan.py:96-111) the index matrix is the global batches' and rank r
replays on its columns of each row (``P(None, "data")``); the step core,
built with the same mesh, holds the gradient, criterion and BatchNorm
all-reduces, and both the dropout and the augmentation seeds fold in the
rank on a mesh above one rank (epoch_scan.py:79-81: each rank draws its own
augmentation, a different but equally distributed stream from the per-step
path's global draws). The captured step holds those all-reduces, so the
group must be NCCL: the eager warm-up runs them once before the capture, so
that the communicator exists, and the capture then records them. A gloo
group on the GPU cannot be captured and the runner refuses it (it does not
replay uncaptured).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.mesh import fold_seed
from ..runtime.spans import active_recorder, host_range, span
from .state import TrainState

__all__ = ["EpochRunner"]


class EpochRunner:
    """``run(idx, base_step) -> metrics``: one epoch of gather -> transform
    -> step core -> EMA over the rows of ``idx`` (JAX ``make_epoch_runner``).
    See the module doc.

    Args:
        state: the train state; its model and optimizer are updated in
            place and ``state.step`` advances by one a step.
        step_core: ``core(state, batch) -> metrics`` (``make_destr_step_core``).
        transform: ``(raw batch, generator) -> model batch``, the device
            augmentation bound to its geometry.
        data: the device-resident set (``DeviceCachedLoader.data``).
        aug_seed: the augmentation generator's seed at a step.
        steps_per_epoch: the metric buffers' length (the longest epoch).
        ema: (EMA parameters, ``update(ema, model)``) or None.
        mesh: the data-parallel mesh the step core was built with, or None.
    """

    def __init__(self, state: TrainState, step_core: Callable, transform: Callable, data: dict,
                 aug_seed: Callable[[int], int], steps_per_epoch: int, ema: Optional[tuple] = None,
                 mesh=None):
        self.state, self.core, self.transform, self.data = state, step_core, transform, data
        self.aug_seed = aug_seed
        self.steps_per_epoch = steps_per_epoch
        self.ema = ema
        self.mesh = mesh
        self.device = next(state.model.parameters()).device
        if self.device.type == "cuda" and mesh is not None and mesh.group is not None and mesh.backend != "nccl":
            raise ValueError(f"a {mesh.backend} group on the GPU cannot be captured: the epoch runner needs NCCL")
        self.aug_generator = torch.Generator(device=self.device)
        self._idx: Optional[torch.Tensor] = None  # the step's index row, (B,)
        self._slot = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._metrics: Optional[dict[str, torch.Tensor]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _body(self) -> None:
        """One step on the static index row, its metrics into the static slot."""
        with span("step"):
            with span("augment"):
                raw = {k: v.index_select(0, self._idx) for k, v in self.data.items()}
                batch = self.transform(raw, self.aug_generator)
            metrics = self.core(self.state, batch)
            if self.ema is not None:
                with span("ema"):
                    ema_params, update = self.ema
                    update(ema_params, self.state.model)
            with span("metrics"):
                if self._metrics is None:  # the first step, eager: the buffers the graph will write
                    self._metrics = {k: torch.zeros((self.steps_per_epoch,), dtype=torch.float32,
                                                    device=self.device) for k in metrics}
                for k, v in metrics.items():
                    self._metrics[k].index_copy_(0, self._slot, v.detach().float().reshape(1))

    def _warm_up_and_capture(self) -> None:
        """Run the body once on a side stream, then capture it."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.state.rng.generator)
        graph.register_generator_state(self.aug_generator)
        if self.mesh is None or self.mesh.group is None:
            with torch.cuda.graph(graph):
                self._body()
        else:
            # the warm-up's collectives have made the communicator; with them
            # finished, no other thread (NCCL's watchdog) touches the device
            # while this one captures
            torch.cuda.synchronize(self.device)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._body()
        self.graph = graph

    def run(self, idx: np.ndarray, base_step: int, after_step: Optional[Callable[[], None]] = None,
            step_scope: Callable[[int], contextlib.AbstractContextManager] = lambda step: contextlib.nullcontext(),
            ) -> dict[str, np.ndarray]:
        """Steps ``base_step, base_step + 1, ...`` on the rows of ``idx`` (n,
        B) int64 set indices (on a mesh the global batches, of which this
        rank takes its columns); returns each metric's n values (one read
        from the device, which waits for the epoch). ``after_step()`` runs on the
        host after each step is enqueued (the driver's step timer), and each
        step's host work runs inside ``step_scope(step)`` (a profiler range)."""
        n = int(idx.shape[0])
        rank = None
        if self.mesh is not None:
            idx, rank = idx[:, self.mesh.rows(idx.shape[1])], self.mesh.fold_rank
        if n > self.steps_per_epoch:
            raise ValueError(f"{n} steps, more than the runner's {self.steps_per_epoch}")
        if self._idx is None:
            self._idx = torch.zeros((idx.shape[1],), dtype=torch.int64, device=self.device)
        if self._idx.shape[0] != idx.shape[1]:
            raise ValueError(f"batches of {idx.shape[1]}, the runner's are {self._idx.shape[0]}")
        # "run" names the call's host time between the finer ranges (under a
        # profiler, mostly the ranges' own entry and exit)
        with host_range("run"):
            with host_range("index_upload"):
                order = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(self.device)
            recorder = active_recorder()
            if recorder is not None:
                recorder.slot = self._slot
            for i in range(n):
                step = base_step + i
                if recorder is not None:
                    recorder.steps[i] = step
                with host_range("enqueue"), step_scope(step):
                    self._idx.copy_(order[i])
                    self._slot.fill_(i)
                    self.state.rng.begin_step(step, rank)
                    self.aug_generator.manual_seed(fold_seed(self.aug_seed(step), rank))
                    if self.device.type != "cuda":
                        self._body()
                    elif self.graph is None:
                        self._warm_up_and_capture()
                    else:
                        self.graph.replay()
                self.state.step = step + 1
                if after_step is not None:
                    after_step()
            if self._metrics is None:
                return {}
            with host_range("metrics_read"):
                return {k: v[:n].cpu().numpy() for k, v in self._metrics.items()}

