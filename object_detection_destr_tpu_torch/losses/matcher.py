"""DESTR and SSD matching (port of ``object_detection_destr_tpu/losses/matcher.py``:
DESTR l.38-119, SSD l.122-186).

``hungarian_cost_matrix`` builds the (B, N, T) cost; ``hungarian_match``
solves it. With ``cost_bbox == 0`` (what the training step uses: class 1,
CIoU 1) matching goes through the fused cost + auction of
``ops/cuda/auction.py`` (kernel #9 on CUDA tensors), as the JAX package
routes it to its fused Pallas kernel; otherwise the cost matrix is solved by
``ops/assignment.py::batched_assignment`` (the precomputed-cost kernel #8 on
CUDA tensors).
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..geometry.boxes import cxcyhw_to_xyxy, pairwise_ciou, pairwise_iou
from ..ops.assignment import batched_assignment
from ..ops.cuda.auction import hungarian_match_fused
from ..ops.focal import focal_cost_terms

__all__ = ["decode_ssd_boxes", "hungarian_cost_matrix", "hungarian_match", "ssd_match"]


def hungarian_cost_matrix(
    outputs: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    cost_class: float = 1.0,
    cost_bbox: float = 0.0,
    cost_ciou: float = 1.0,
) -> torch.Tensor:
    """(B, N, T) cost: focal pos - neg at the target's label, 1 - CIoU, and
    with ``cost_bbox`` the raw L1 between cxcyhw predictions and xyxy
    targets, as the reference mixes them (matcher.py:38-79)."""
    out_prob = torch.sigmoid(outputs["pred_class"].float())
    out_bbox = outputs["pred_boxes"].float()
    tgt_ids = targets["labels"].long()
    tgt_bbox = targets["boxes"].float()
    pos, neg = focal_cost_terms(out_prob)  # (B, N, C)
    idx = tgt_ids[:, None, :].expand(pos.shape[0], pos.shape[1], tgt_ids.shape[1])
    cost = cost_class * (pos.gather(-1, idx) - neg.gather(-1, idx))
    if cost_ciou:
        cost = cost + cost_ciou * pairwise_ciou(cxcyhw_to_xyxy(out_bbox), tgt_bbox)
    if cost_bbox:
        l1 = (out_bbox[:, :, None, :] - tgt_bbox[:, None, :, :]).abs().sum(-1)
        cost = cost + cost_bbox * l1
    return cost


def hungarian_match(
    outputs: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    cost_class: float = 1.0,
    cost_bbox: float = 0.0,
    cost_ciou: float = 1.0,
    eps_frac: float = 0.001,
    max_iters: int = 256,
) -> torch.Tensor:
    """(B, T) int64 query row per target, duplicate-free; no gradient."""
    with torch.no_grad():
        if cost_bbox == 0:
            return hungarian_match_fused(
                outputs["pred_class"], outputs["pred_boxes"], targets["boxes"],
                targets["labels"], targets["valid"], cost_class=cost_class,
                cost_ciou=cost_ciou, eps_frac=eps_frac, max_iters=max_iters,
            )
        cost = hungarian_cost_matrix(outputs, targets, cost_class, cost_bbox, cost_ciou)
        return batched_assignment(cost, targets["valid"], eps_frac=eps_frac, max_iters=max_iters)


def decode_ssd_boxes(pred_boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Predicted offsets (dx, dy, dh, dw) against the default boxes -> cxcyhw
    (matcher.py:122-146):

        cx = a0 + a3 * dx;  cy = a1 + a2 * dy;  h = a2 * exp(dh);  w = a3 * exp(dw)

    ``anchors`` is (S, 4) in ``geometry.default_boxes``' (y-ish, x-ish, h, w)
    layout, kept as the reference has it (self-consistent on square grids).

    Args:
        pred_boxes: (B, S, 4) raw head outputs; anchors: (S, 4).
    """
    a = anchors[None]
    return torch.stack([
        a[..., 0] + a[..., 3] * pred_boxes[..., 0],
        a[..., 1] + a[..., 2] * pred_boxes[..., 1],
        a[..., 2] * torch.exp(pred_boxes[..., 2]),
        a[..., 3] * torch.exp(pred_boxes[..., 3]),
    ], dim=-1)


@torch.no_grad()
def ssd_match(
    decoded_xyxy: torch.Tensor,
    gt_xyxy: torch.Tensor,
    gt_valid: torch.Tensor,
    iou_thresh: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD anchor matching as a dense match matrix (matcher.py:149-186): each
    valid target force-matches its best-IoU prediction (the first maximum,
    as ``jnp.argmax``), whose IoU entry is then zeroed, and every other pair
    with IoU >= ``iou_thresh`` matches too. Invalid targets get IoU -1. No
    gradient: the matching is a fixed target.

    Args:
        decoded_xyxy: (B, S, 4); gt_xyxy: (B, T, 4); gt_valid: (B, T) bool.

    Returns:
        match: (B, S, T) bool; positive: (B, S) bool, the predictions matched
        to at least one target (the rest are negatives).
    """
    iou = torch.where(gt_valid[:, None, :], pairwise_iou(decoded_xyxy, gt_xyxy), -1.0)  # (B, S, T)
    s = decoded_xyxy.shape[1]
    best_pred = iou.argmax(dim=1)  # (B, T)
    forced = (torch.arange(s, device=iou.device)[None, :, None] == best_pred[:, None, :]) & gt_valid[:, None, :]
    match = forced | (torch.where(forced, 0.0, iou) >= iou_thresh)
    return match, match.any(dim=-1)
