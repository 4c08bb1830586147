"""Fused DESTR matching cost + auction: the hand-written CUDA kernel
``csrc/auction.cu``, its ctypes binding, and its plain PyTorch version.

Port of ``object_detection_destr_tpu/ops/pallas/auction.py::
hungarian_match_pallas`` (l.371) and its kernel ``_fused_kernel`` (l.271):
the focal pos - neg class cost at each target's label plus 1 - CIoU, solved
by the Bertsekas auction of ``_solve`` (l.71) in one launch, with a
per-problem ``row_valid`` so problems with different real row counts (the
model's top-k queries and the mini-detector's tokens) share the launch.
As in the Pallas wrapper, the focal terms and the per-box atan(w / h) of the
clipped cxcyhw forms are computed beside the kernel
(:func:`fused_cost_inputs`), the rest of the cost inside it.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`hungarian_match_fused_reference` (the cost built elementwise in the
kernel's operation order, then ``ops/assignment.py::solve_auction``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...geometry.boxes import cxcyhw_to_xyxy, xyxy_to_cxcyhw
from ..assignment import BIG, solve_auction
from ..focal import focal_cost_terms
from .build import CudaLibrary

__all__ = [
    "FusedAuction",
    "fused_auction",
    "fused_cost_inputs",
    "hungarian_match_fused",
    "hungarian_match_fused_reference",
    "matching_value_reference",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary(
    "odtt_auction", "auction.cu",
    functions={"odtt_fused_auction": (_I, [_P] * 12 + [_I] * 4 + [_F] * 3 + [_I, _P])},
    abi=("odtt_auction_abi_version", 2),
    flags=("-fmad=false",),
)


def fused_cost_inputs(pred_logits, pred_boxes, tgt_boxes, eps: float = 1e-6):
    """The terms computed beside the kernel (auction.py:407-422):
    pn (B, C, N) = focal pos - neg per class, atan(w/h) of the predictions'
    clipped cxcyhw form (B, N) and of the targets' (B, T)."""
    pos, neg = focal_cost_terms(torch.sigmoid(pred_logits.float()))
    pn = (pos - neg).transpose(1, 2).contiguous()
    pc = xyxy_to_cxcyhw(cxcyhw_to_xyxy(pred_boxes.float()))
    atan_p = torch.atan(pc[..., 3] / torch.clamp(pc[..., 2], min=eps))
    gc = xyxy_to_cxcyhw(tgt_boxes.float())
    atan_g = torch.atan(gc[..., 3] / torch.clamp(gc[..., 2], min=eps))
    return pn, atan_p.contiguous(), atan_g.contiguous()


def matching_value_reference(pn, pred_boxes, atan_p, tgt_boxes, atan_g, labels, col_valid,
                             row_valid, cost_class: float = 1.0, cost_ciou: float = 1.0,
                             epsilon: float = 1e-6) -> torch.Tensor:
    """The kernel's (B, T, N) value matrix, operation for operation
    (auction.py:306-360): -cost on valid columns, 0 on invalid ones, -1e9 on
    rows that are not real."""
    b, c, n = pn.shape
    in_range = (labels >= 0) & (labels < c)
    lab = labels.clamp(0, c - 1).long()
    c_class = torch.where(in_range[..., None], pn.gather(1, lab[..., None].expand(b, lab.shape[1], n)), 0.0)

    p = pred_boxes.float()[:, None, :, :]  # (B, 1, N, 4)
    cx, cy, h, w = p.unbind(-1)
    px1 = torch.clamp(cx - w / 2, min=0.0)
    py1 = torch.clamp(cy - h / 2, min=0.0)
    px2 = torch.clamp(cx + w / 2, max=1.0)
    py2 = torch.clamp(cy + h / 2, max=1.0)
    tx1, ty1, tx2, ty2 = tgt_boxes.float()[:, :, None, :].unbind(-1)  # (B, T, 1)
    iw = torch.clamp(torch.minimum(px2, tx2) - torch.maximum(px1, tx1), min=0.0)
    ih = torch.clamp(torch.minimum(py2, ty2) - torch.maximum(py1, ty1), min=0.0)
    inter = iw * ih
    parea = (px2 - px1) * (py2 - py1)
    tarea = (tx2 - tx1) * (ty2 - ty1)
    iou = inter / torch.clamp(parea + tarea - inter, min=epsilon)
    ew = torch.clamp(torch.maximum(px2, tx2) - torch.minimum(px1, tx1), min=0.0)
    eh = torch.clamp(torch.maximum(py2, ty2) - torch.minimum(py1, ty1), min=0.0)
    diag_sq = ew * ew + eh * eh
    dx = torch.clamp((px1 + px2) / 2, 0.0, 1.0) - torch.clamp((tx1 + tx2) / 2, 0.0, 1.0)
    dy = torch.clamp((py1 + py2) / 2, 0.0, 1.0) - torch.clamp((ty1 + ty2) / 2, 0.0, 1.0)
    center_sq = dx * dx + dy * dy
    da = atan_g[:, :, None] - atan_p[:, None, :]
    v = (4.0 / math.pi**2) * (da * da)
    alpha = torch.where(iou > 0.5, v / (1.0 - iou + v), 0.0)
    cious = torch.clamp(iou - center_sq / torch.clamp(diag_sq, min=epsilon) - alpha * v, -1.0, 1.0)
    cost = cost_class * c_class + cost_ciou * (1.0 - cious)
    value = torch.where(col_valid[:, :, None], -cost, 0.0)
    return torch.where(row_valid[:, None, :], value, -BIG)


def _row_valid(pred_logits, row_valid):
    if row_valid is None:
        return torch.ones(pred_logits.shape[:2], dtype=torch.bool, device=pred_logits.device)
    return row_valid


def hungarian_match_fused_reference(pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid,
                                    row_valid=None, cost_class: float = 1.0,
                                    cost_ciou: float = 1.0, eps_frac: float = 0.001,
                                    max_iters: int = 256):
    """The kernel's function in plain PyTorch: (rows (B, T) int64, rounds (B,))."""
    row_valid = _row_valid(pred_logits, row_valid)
    pn, atan_p, atan_g = fused_cost_inputs(pred_logits, pred_boxes, tgt_boxes)
    value = matching_value_reference(pn, pred_boxes, atan_p, tgt_boxes, atan_g, tgt_labels,
                                     col_valid, row_valid, cost_class, cost_ciou)
    return solve_auction(value, col_valid, row_valid, eps_frac, max_iters)


class FusedAuction:
    """The kernel's wrapper: computes the terms beside it, checks the
    operands, allocates outputs and scratch and launches one block per
    problem on the current stream. ``launches`` counts kernel launches and
    nothing else; ``last_rounds`` and ``last_bids`` hold the (B,) bidding
    rounds and the bids made over them in the last launch (read them only
    after a synchronize)."""

    library = LIBRARY

    def __init__(self):
        self.launches = 0
        self.last_rounds: Optional[torch.Tensor] = None
        self.last_bids: Optional[torch.Tensor] = None

    def __call__(self, pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid, row_valid=None,
                 cost_class: float = 1.0, cost_ciou: float = 1.0, eps_frac: float = 0.001,
                 max_iters: int = 256):
        """Returns (rows (B, T) int64, rounds (B,) int32)."""
        row_valid = _row_valid(pred_logits, row_valid)
        tensors = (pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid, row_valid)
        if not all(t.is_cuda and t.device == pred_logits.device for t in tensors):
            raise ValueError("fused_auction: every operand must be on one CUDA device")
        b, n, c = pred_logits.shape
        t = tgt_boxes.shape[1]
        if pred_boxes.shape != (b, n, 4) or tgt_boxes.shape != (b, t, 4) \
                or tgt_labels.shape != (b, t) or col_valid.shape != (b, t) or row_valid.shape != (b, n):
            raise ValueError("fused_auction: shape mismatch")
        if col_valid.dtype != torch.bool or row_valid.dtype != torch.bool:
            raise TypeError("col_valid and row_valid must be bool")
        if t > n or t == 0:
            raise ValueError(f"fused_auction needs 0 < T <= N, got T={t}, N={n}")
        pn, atan_p, atan_g = fused_cost_inputs(pred_logits, pred_boxes, tgt_boxes)
        boxes = pred_boxes.float().contiguous()
        targets = tgt_boxes.float().contiguous()
        labels = tgt_labels.to(torch.int32).contiguous()
        colv, rowv = col_valid.contiguous(), row_valid.contiguous()
        dev = pred_logits.device
        value = torch.empty((b, t, n), dtype=torch.float32, device=dev)
        rows = torch.empty((b, t), dtype=torch.int32, device=dev)
        rounds = torch.empty((b,), dtype=torch.int32, device=dev)
        bids = torch.empty((b,), dtype=torch.int32, device=dev)
        lib = self.library.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.odtt_fused_auction(
                pn.data_ptr(), boxes.data_ptr(), atan_p.data_ptr(), targets.data_ptr(),
                atan_g.data_ptr(), labels.data_ptr(), colv.data_ptr(), rowv.data_ptr(),
                value.data_ptr(), rows.data_ptr(), rounds.data_ptr(), bids.data_ptr(), b, n, t, c,
                float(cost_class), float(cost_ciou), float(eps_frac), int(max_iters), stream,
            )
        if err != 0:
            raise RuntimeError(f"fused_auction launch failed: CUDA error {err}")
        self.launches += 1
        self.last_rounds, self.last_bids = rounds, bids
        return rows.long(), rounds


fused_auction = FusedAuction()


def hungarian_match_fused(pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid,
                          row_valid=None, cost_class: float = 1.0, cost_ciou: float = 1.0,
                          eps_frac: float = 0.001, max_iters: int = 256) -> torch.Tensor:
    """(B, T) int64 query row per target, duplicate-free: the kernel for
    CUDA tensors, its plain version for CPU tensors. No gradient flows."""
    with torch.no_grad():
        fn = fused_auction if pred_logits.is_cuda else hungarian_match_fused_reference
        return fn(pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid, row_valid,
                  cost_class, cost_ciou, eps_frac, max_iters)[0]
