"""Box geometry (port of ``object_detection_destr_tpu/geometry/boxes.py``).

Boxes are normalized to [0, 1]; ``cxcyhw`` is (center_x, center_y, height,
width), h before w, as the reference has it (bbox_utils.py:33-63).
``pairwise_*`` broadcast (..., N, 4) against (..., M, 4) to (..., N, M).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "cxcyhw_to_xyxy",
    "xyxy_to_cxcyhw",
    "pairwise_iou",
    "pairwise_ciou",
    "elementwise_iou",
    "elementwise_ciou",
    "box_l1_size",
    "flat_box_mask",
]


def cxcyhw_to_xyxy(
    boxes: torch.Tensor, min_val: float = 0.0, max_val: float = 1.0
) -> torch.Tensor:
    """(cx, cy, h, w) -> (x1, y1, x2, y2), clipping x1/y1 >= min and x2/y2 <= max
    (boxes.py:44-59): only the mins are clipped from below and the maxes
    from above."""
    cx, cy, h, w = boxes.unbind(-1)
    return torch.stack(
        [
            torch.clamp(cx - w / 2, min=min_val),
            torch.clamp(cy - h / 2, min=min_val),
            torch.clamp(cx + w / 2, max=max_val),
            torch.clamp(cy + h / 2, max=max_val),
        ],
        dim=-1,
    )


def xyxy_to_cxcyhw(
    boxes: torch.Tensor, min_val: float = 0.0, max_val: float = 1.0
) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, h, w), every component clipped into
    [min, max] (boxes.py:62-72)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack(
        [(x1 + x2) / 2, (y1 + y2) / 2, y2 - y1, x2 - x1], dim=-1
    ).clamp(min_val, max_val)


def _area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _ciou_terms(p, g, pred_c, gt_c, iou, epsilon):
    """1 - CIoU from broadcast-aligned xyxy / cxcyhw operands (boxes.py:127-146)."""
    enclose_wh = torch.clamp(
        torch.maximum(p[..., 2:], g[..., 2:]) - torch.minimum(p[..., :2], g[..., :2]), min=0.0
    )
    diag_sq = (enclose_wh**2).sum(-1)
    center_dist_sq = ((pred_c[..., :2] - gt_c[..., :2]) ** 2).sum(-1)
    atan_gt = torch.atan(gt_c[..., 3] / torch.clamp(gt_c[..., 2], min=epsilon))
    atan_pred = torch.atan(pred_c[..., 3] / torch.clamp(pred_c[..., 2], min=epsilon))
    v = (4.0 / math.pi**2) * (atan_gt - atan_pred) ** 2
    # alpha is a constant for the gradient, active only where IoU > 0.5
    with torch.no_grad():
        alpha = (iou > 0.5).to(v.dtype) * (v / (1.0 - iou + v))
    cious = torch.clamp(iou - center_dist_sq / torch.clamp(diag_sq, min=epsilon) - alpha * v, -1.0, 1.0)
    return 1.0 - cious


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """IoU of (..., N, 4) x (..., M, 4) xyxy boxes -> (..., N, M); intersection
    clamped at 0, union at epsilon (boxes.py:91-104)."""
    b1, b2 = boxes1[..., :, None, :], boxes2[..., None, :, :]
    inter_wh = torch.clamp(
        torch.minimum(b1[..., 2:], b2[..., 2:]) - torch.maximum(b1[..., :2], b2[..., :2]), min=0.0
    )
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = _area(b1) + _area(b2) - inter
    return inter / torch.clamp(union, min=epsilon)


def pairwise_ciou(pred_xyxy: torch.Tensor, gt_xyxy: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """``1 - CIoU`` for every (pred, gt) pair (boxes.py:107-146): the aspect
    term gated at IoU > 0.5 with alpha held constant, clamp to [-1, 1],
    centres and aspect from the clipped cxcyhw forms."""
    pred_c = xyxy_to_cxcyhw(pred_xyxy)[..., :, None, :]
    gt_c = xyxy_to_cxcyhw(gt_xyxy)[..., None, :, :]
    iou = pairwise_iou(pred_xyxy, gt_xyxy, epsilon)
    return _ciou_terms(pred_xyxy[..., :, None, :], gt_xyxy[..., None, :, :], pred_c, gt_c, iou, epsilon)


def elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """IoU of aligned (..., 4) xyxy pairs -> (...) (boxes.py:149-156)."""
    inter_wh = torch.clamp(
        torch.minimum(boxes1[..., 2:], boxes2[..., 2:]) - torch.maximum(boxes1[..., :2], boxes2[..., :2]),
        min=0.0,
    )
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = _area(boxes1) + _area(boxes2) - inter
    return inter / torch.clamp(union, min=epsilon)


def elementwise_ciou(pred_xyxy: torch.Tensor, gt_xyxy: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """``1 - CIoU`` of aligned (..., 4) pairs (boxes.py:159-188)."""
    iou = elementwise_iou(pred_xyxy, gt_xyxy, epsilon)
    return _ciou_terms(pred_xyxy, gt_xyxy, xyxy_to_cxcyhw(pred_xyxy), xyxy_to_cxcyhw(gt_xyxy), iou, epsilon)


def box_l1_size(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """|w| + |h| per box — the pair-ordering key of DESTR pair attention
    (boxes.py:191-196)."""
    return torch.abs(boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) + torch.abs(
        boxes_xyxy[..., 3] - boxes_xyxy[..., 1]
    )


def flat_box_mask(boxes_xyxy: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """True where a box has positive width and height (boxes.py:199-208)."""
    w = boxes_xyxy[..., 2] - boxes_xyxy[..., 0]
    h = boxes_xyxy[..., 3] - boxes_xyxy[..., 1]
    return (w > epsilon) & (h > epsilon)
