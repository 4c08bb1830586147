"""The greedy first-match walk of both mAP metrics: the hand-written CUDA
kernel of ``csrc/greedy_match.cu``, its ctypes binding, and its plain
PyTorch version.

The JAX package walks the ranks with ``lax.scan`` inside ``vmap``s over
images and classes (``object_detection_destr_tpu/losses/metrics.py``:
``_update_one_class`` l.83-98, ``_coco_batch_records`` l.265-278), compiled
into the metric's one program. Here every (image, class) problem of a batch
goes to one launch. Per problem, ``iou`` (R, T) holds -1 where the target
is not a valid target of the class, and the ranks below ``n_use`` count;
each threshold is matched on its own:

* ``skip_matched=False``, the 11-point rule (l.84-92): the best-IoU target,
  a miss if it is matched already;
* ``skip_matched=True``, COCO's rule (l.265-275): the best target not yet
  matched (matched targets read as -1);

a hit marks its target matched. The argmax is ``jnp.argmax``'s: the first
index wins ties and a NaN counts as the maximum, so a NaN row never hits.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import CudaLibrary, LaunchCounter

__all__ = ["GreedyMatch", "greedy_match", "greedy_match_kernel", "greedy_match_reference"]

MAX_THRESHOLDS = 32  # one warp a threshold in the kernel's block

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "odtt_greedy_match", "greedy_match.cu",
    functions={"odtt_greedy_match": (_I, [_P, _P, _P, _P] + [_I] * 5 + [_P])},
    abi=("odtt_greedy_match_abi_version", 1),
)


def _check(iou: torch.Tensor, n_use: torch.Tensor, thresholds: Sequence[float]) -> None:
    if iou.dim() != 3 or n_use.shape != iou.shape[:1]:
        raise ValueError(f"greedy_match takes iou (P, R, T) and n_use (P,), got {tuple(iou.shape)} and "
                         f"{tuple(n_use.shape)}")
    if not 1 <= len(thresholds) <= MAX_THRESHOLDS:
        raise ValueError(f"greedy_match takes 1 to {MAX_THRESHOLDS} thresholds, got {len(thresholds)}")


def greedy_match_reference(iou: torch.Tensor, n_use: torch.Tensor, thresholds: Sequence[float],
                           skip_matched: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch, the ``lax.scan``'s
    counterpart: a loop over the R ranks of batched ops on (P, J, T).

    Args:
        iou: (P, R, T) float32, -1 where the target is not a valid one.
        n_use: (P,) integer, the ranks that count in each problem.
        thresholds: J IoU thresholds.
        skip_matched: COCO's rule (True) or the 11-point rule (False).

    Returns:
        (P, R, J) bool hits.
    """
    _check(iou, n_use, thresholds)
    p, r, t = iou.shape
    dev = iou.device
    thr = torch.tensor([float(x) for x in thresholds], dtype=torch.float32, device=dev)
    j = thr.shape[0]
    iou = iou.float()
    hits = torch.zeros((p, r, j), dtype=torch.bool, device=dev)
    matched = torch.zeros((p, j, t), dtype=torch.bool, device=dev)
    for i in range(r):
        row = iou[:, None, i, :].expand(p, j, t)
        if skip_matched:
            row = torch.where(matched, -1.0, row)
        best = row.argmax(-1, keepdim=True)  # (P, J, 1): the first maximum, NaN the largest
        hit = (row.gather(-1, best) >= thr[:, None]) & ~matched.gather(-1, best)
        hit &= (i < n_use)[:, None, None]
        matched.scatter_(-1, best, matched.gather(-1, best) | hit)
        hits[:, i] = hit[..., 0]
    return hits


class GreedyMatch(LaunchCounter):
    """The kernel's wrapper: checks the operands, allocates the hits and
    launches one block per problem on the current stream. ``launches``
    counts kernel launches and nothing else."""

    library = LIBRARY

    def __call__(self, iou: torch.Tensor, n_use: torch.Tensor, thresholds: Sequence[float],
                 skip_matched: bool) -> torch.Tensor:
        """The arguments of :func:`greedy_match_reference`; (P, R, J) bool hits."""
        _check(iou, n_use, thresholds)
        if not (iou.is_cuda and n_use.device == iou.device):
            raise ValueError("greedy_match_kernel: iou and n_use must be on one CUDA device")
        if iou.dtype != torch.float32:
            raise TypeError(f"greedy_match_kernel takes float32 iou, got {iou.dtype}")
        p, r, t = iou.shape
        j = len(thresholds)
        iou, n_use = iou.contiguous(), n_use.to(torch.int32).contiguous()
        hits = torch.empty((p, r, j), dtype=torch.bool, device=iou.device)
        thr = (ctypes.c_float * j)(*[float(x) for x in thresholds])
        lib = self.library.library()
        with torch.cuda.device(iou.device):
            stream = torch.cuda.current_stream(iou.device).cuda_stream
            err = lib.odtt_greedy_match(iou.data_ptr(), n_use.data_ptr(), thr, hits.data_ptr(), p, r, t, j,
                                        int(bool(skip_matched)), stream)
        if err != 0:
            raise RuntimeError(f"greedy_match launch failed: CUDA error {err}")
        self.count_launch(stream)
        return hits


greedy_match_kernel = GreedyMatch()


def greedy_match(iou: torch.Tensor, n_use: torch.Tensor, thresholds: Sequence[float],
                 skip_matched: bool) -> torch.Tensor:
    """(P, R, J) bool hits: the kernel for CUDA tensors, its plain version
    for CPU ones."""
    with torch.no_grad():
        fn = greedy_match_kernel if iou.is_cuda else greedy_match_reference
        return fn(iou, n_use, thresholds, skip_matched)
