"""The data-parallel mesh on an explicit ``torch.distributed`` group (port of
``object_detection_destr_tpu/parallel/mesh.py``: ``auto_mesh`` l.31-49,
``make_mesh`` l.52-68, ``batch_sharding``, ``replicated_sharding`` and
``shard_batch`` l.71-82).

The JAX package lays the batch over a ('data', 'model') device mesh and runs
each step under ``shard_map``: every device sees its rows of the global
batch, the parameters are replicated, and the step's collectives (the
gradient psum, the criterion's global-batch reductions, the BatchNorm
pmean) ride the mesh. Here a rank is one process (or, in the CPU tests and
the card's two-rank check, one thread) that owns one device, and a
:class:`Mesh` is that rank's view of the data axis: its explicit process
group (None on a single device), its index on the axis, the axis' size and
its device. Every collective of the port takes the mesh's group explicitly;
none relies on the default group. ``make_mesh(num_data, num_model)`` lays
the ranks on JAX's grid: global rank r sits at data index r // num_model and
model index r % num_model. Each model column is a data axis of its own (one
group), and the parameters are replicated over 'model', as in JAX: the ranks
of a row read the same rows and take the same steps.

Rank r of N holds rows ``[r B / N, (r + 1) B / N)`` of a global batch of B
(``shard_batch``, :meth:`Mesh.rows`). ``--batch_size`` stays the global
batch.

Under a launcher (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) the entry points run inside
:func:`launched`, which binds the rank to its GPU, initialises NCCL (gloo
with ``--device cpu``) with a short timeout and destroys the group on every
exit path. Two NCCL ranks never share a GPU (NCCL refuses duplicate devices
in a communicator): two ranks on one card use gloo
(:func:`group_from_store`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "CPU_TIMEOUT",
    "DEFAULT_TIMEOUT",
    "Mesh",
    "Sharding",
    "auto_mesh",
    "batch_sharding",
    "fold_seed",
    "group_from_store",
    "launched",
    "make_mesh",
    "replicated_sharding",
    "shard_batch",
]

# every group of the port waits at most this long in a collective; gloo
# ranks on the CPU, whose steps take seconds where the GPU's take
# milliseconds, wait longer
DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)
CPU_TIMEOUT = datetime.timedelta(seconds=300)


def fold_seed(seed: int, rank: Optional[int]) -> int:
    """A generator seed with a rank folded in (``jax.random.fold_in(key,
    axis_index)``); ``rank`` None leaves it as it is."""
    return seed if rank is None else seed * 1_000_033 + rank + 1


class _AllReduceSum(torch.autograd.Function):
    """Sum over the mesh, whose backward sums the gradient over the mesh:
    each rank's input reaches every rank's output, so the gradient of an
    input is the sum of the output gradients of all ranks."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.all_reduce_(grad.clone(memory_format=torch.contiguous_format)), None


class Mesh:
    """One rank's view of the ('data',) axis: ``group`` (a
    ``torch.distributed`` process group, or None on a single device),
    ``rank`` (this rank's index on the axis), ``size`` (the axis' size),
    ``device``, ``backend`` ("nccl", "gloo" or None) and ``model_index``
    (its index on the replicated 'model' axis).

    A mesh with a group runs its collectives through the group, also when
    its size is 1; a mesh without one has size 1 and its collectives are
    the identity. ``active`` is False on a rank that the data axis leaves
    out (:func:`auto_mesh` on a world that the batch does not divide): such
    a rank takes no part in training."""

    def __init__(self, group, rank: int, size: int, device: torch.device, backend: Optional[str] = None,
                 active: bool = True, model_index: int = 0):
        if group is None and size != 1:
            raise ValueError(f"a mesh of size {size} needs a process group")
        self.group, self.rank, self.size = group, rank, size
        self.device, self.backend, self.active = torch.device(device), backend, active
        self.model_index = model_index
        self._grad_buffer = None  # (the parameters' ids, the flat buffer, a view a parameter)

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, model_index={self.model_index}, device={self.device}, "
                f"backend={self.backend}, active={self.active})")

    def __deepcopy__(self, memo) -> "Mesh":  # a group is not copied: a copied model syncs over the same one
        return self

    @property
    def is_main(self) -> bool:
        """Grid position (0, 0) of an active mesh: the one rank that
        prints, logs and writes checkpoints."""
        return self.active and self.rank == 0 and self.model_index == 0

    def axis_index(self) -> int:
        """``jax.lax.axis_index("data")``."""
        return self.rank

    @property
    def fold_rank(self) -> Optional[int]:
        """What a rank folds into its dropout and scanned-augmentation seeds:
        its index on an axis above 1, None on an axis of 1 (whose seeds stay
        the single device's)."""
        return self.rank if self.size > 1 else None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    # ---- collectives, each on the mesh's group
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh in place (no autograd) and return it."""
        if self.group is not None:
            opts = dist.AllreduceOptions()
            opts.reduceOp = dist.ReduceOp.SUM
            self.group.allreduce([t], opts).wait()
        return t

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``jax.lax.psum``, differentiable: the backward sums the gradient
        over the mesh (:class:`_AllReduceSum`).

        On a gloo group over CUDA tensors the sum runs on a host copy: the
        autograd engine runs a CUDA node's backward on the device's one
        worker thread, shared by every thread of the process, and a rank
        blocked there in a collective would stall the other ranks' backward
        (thread-ranks on one card); a CPU node's backward runs on the thread
        that called ``backward``."""
        if self.group is None:
            return x
        if self.backend == "gloo" and x.device.type == "cuda":
            return _AllReduceSum.apply(x.cpu(), self).to(x.device)
        return _AllReduceSum.apply(x, self)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """``jax.lax.pmean``, differentiable (:meth:`psum` over the size)."""
        return x if self.group is None else self.psum(x) / self.size

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on the leading axis in rank order
        (``out_specs=P("data")``): the global batch from the local rows."""
        if self.group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self.group.allgather([parts], [t]).wait()
        return torch.cat(parts)

    def all_reduce_grads(self, params, mean: bool = False) -> None:
        """Sum (``mean``: average) the gradient of every parameter that has
        one over the mesh, in one collective on a flat float32 buffer that
        the mesh keeps from step to step (a captured step's is static). The
        gradients are copied in, reduced in place, and each float32
        parameter's ``.grad`` becomes its view of the buffer."""
        if self.group is None:
            return
        params = [p for p in params if p.grad is not None]
        key = tuple(id(p) for p in params)
        if self._grad_buffer is None or self._grad_buffer[0] != key:
            flat = torch.empty(sum(p.numel() for p in params), dtype=torch.float32, device=params[0].grad.device)
            views = [part.view_as(p) for part, p in zip(flat.split([p.numel() for p in params]), params)]
            self._grad_buffer = (key, flat, views)
        _, flat, views = self._grad_buffer
        torch._foreach_copy_(views, [p.grad for p in params])
        self.all_reduce_(flat)
        if mean:
            flat.div_(self.size)
        for p, view in zip(params, views):
            if p.dtype == flat.dtype:
                p.grad = view
            else:
                p.grad.copy_(view)

    def barrier(self) -> None:
        """Every rank waits here for the others (an all-reduce read back)."""
        if self.group is not None:
            self.all_reduce_(torch.zeros((1,), device=self.device)).item()


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies over the mesh: its leading axis split on 'data'
    (``split``, ``P("data")``) or replicated (``P()``)."""

    mesh: Mesh
    split: bool

    def place(self, x) -> torch.Tensor:
        """This rank's part of ``x`` (a numpy array or a tensor) on the mesh's
        device: its rows, or all of it."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if self.split:
            t = t[self.mesh.rows(t.shape[0])]
        return t.to(self.mesh.device)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading axis split across 'data'."""
    return Sharding(mesh, True)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a host batch, on its device."""
    sharding = batch_sharding(mesh)
    return {k: sharding.place(v) for k, v in batch.items()}


def _world() -> tuple[object, int, int, Optional[str]]:
    """(group, rank, size, backend) of the launcher's world, or a world of
    one device."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dist.get_backend()
    return None, 0, 1, None


def make_mesh(num_data: Optional[int] = None, num_model: int = 1, group=None, device=None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's view of the (num_data, num_model) mesh (``num_data``
    default: all ranks over ``num_model``).

    ``group`` is an explicit group whose every rank is on the data axis
    (``backend`` names its backend; 'model' of size 1); without one the mesh
    is over the launcher's world (one device outside a launcher). Below the
    whole world the ranks take JAX's grid (``make_mesh``'s reshape to
    (num_data, num_model)): global rank r is at data index r // num_model
    and model index r % num_model, and its data axis is the group of its
    model column. Every rank creates the num_model column groups, in column
    order; ranks past the grid get an inactive mesh. ``device`` is this
    rank's (the GPU unless "cpu" is asked for)."""
    device = resolve_device(device)
    explicit = group is not None
    if explicit:
        rank, n = group.rank(), group.size()
    else:
        group, rank, n, backend = _world()
    if num_data is None:
        num_data = n // num_model
    if num_data * num_model > n:
        raise ValueError(f"mesh {num_data}x{num_model} needs {num_data * num_model} devices, have {n}")
    if num_data == n:
        return Mesh(group, rank, n, device, backend)
    if explicit:
        raise ValueError(f"a {num_data}x{num_model} mesh inside an explicit group of {n} ranks")
    timeout = CPU_TIMEOUT if device.type == "cpu" else DEFAULT_TIMEOUT
    columns = [dist.new_group([d * num_model + m for d in range(num_data)], timeout=timeout)
               for m in range(num_model)]
    if rank >= num_data * num_model:
        return Mesh(None, 0, 1, device, backend, active=False)
    return Mesh(columns[rank % num_model], rank // num_model, num_data, device, backend,
                model_index=rank % num_model)


def auto_mesh(batch_size: int, group=None, device=None, backend: Optional[str] = None) -> Mesh:
    """Mesh over the largest rank count that divides ``batch_size`` (a
    batch must split evenly across 'data').

    When ``batch_size`` is not divisible by the rank count, a smaller mesh
    is chosen and the leftover ranks sit idle — that is a silent throughput
    loss, so it is logged loudly (e.g. batch 12 on 8 ranks -> 6-rank mesh, 2
    idle)."""
    n = group.size() if group is not None else _world()[2]
    num_data = max(d for d in range(1, n + 1) if batch_size % d == 0)
    if num_data < n:
        logger.warning(
            "auto_mesh: batch_size=%d is not divisible by the %d available "
            "devices; using a %d-device data mesh and leaving %d device(s) "
            "idle. Pick a batch size divisible by %d for full utilization.",
            batch_size, n, num_data, n - num_data, n,
        )
    return make_mesh(num_data=num_data, group=group, device=device, backend=backend)


def group_from_store(store, rank: int, size: int, backend: str = "gloo",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """An explicit group of ``size`` ranks that meet in ``store`` (a
    ``torch.distributed.Store``), without the default group: ranks as
    threads of one process share a ``HashStore``. ``backend`` "gloo" or
    "nccl"; every collective waits at most ``timeout``."""
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, size, timeout)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"backend={backend!r}: gloo or nccl")


def _launcher_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


@contextlib.contextmanager
def launched(device: str | torch.device | None = None) -> Iterator[torch.device]:
    """The context an entry point runs in; yields the rank's device.

    Outside a launcher: ``resolve_device(device)``, and nothing else. Under
    one (its variables set): the GPU ``LOCAL_RANK`` made current and NCCL
    initialised with :data:`DEFAULT_TIMEOUT`, or gloo on the CPU where
    ``device`` is "cpu", with :data:`CPU_TIMEOUT`; the group is destroyed
    when the body ends, however it ends."""
    if not _launcher_env():
        yield resolve_device(device)
        return
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        backend, dev, timeout = "gloo", torch.device("cpu"), CPU_TIMEOUT
    else:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} has no GPU of its own ({torch.cuda.device_count()} "
                               "visible): two NCCL ranks cannot share one")
        torch.cuda.set_device(local)
        backend, dev, timeout = "nccl", torch.device("cuda", local), DEFAULT_TIMEOUT
    dist.init_process_group(backend, timeout=timeout)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
