"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/geometry/boxes.py`` l.1-202, its kernels replaced by their plain versions and its data-parallel paths left out.]

Box geometry (port of ``object_detection_destr_tpu/geometry/boxes.py``).

Boxes are normalized to [0, 1]; ``cxcyhw`` is (center_x, center_y, height,
width), h before w, as the reference has it (bbox_utils.py:33-63).
``pairwise_*`` broadcast (..., N, 4) against (..., M, 4) to (..., N, M).
"""

from __future__ import annotations

import math
from typing import Sequence

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
    "xywh_to_xyxy",
    "make_grid",
    "default_boxes",
    "clip_boxes_to_window",
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


def xywh_to_xyxy(boxes: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """(x1, y1, w, h) -> (x1, y1, x2, y2), clipping x2/y2 <= max (boxes.py:75-85)."""
    x1, y1, w, h = boxes.unbind(-1)
    return torch.stack([x1, y1, torch.clamp(x1 + w, max=max_val), torch.clamp(y1 + h, max=max_val)], dim=-1)


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


def make_grid(height: int, width: int, bias: float = 0.5, norm: bool = True,
              device: torch.device | str | None = None) -> torch.Tensor:
    """(height, width, 2) float32 grid of (y, x) cell coordinates,
    ``((i + bias) / height, (j + bias) / width)`` when ``norm`` (boxes.py:211-224)."""
    h = torch.arange(height, dtype=torch.float32, device=device) + bias
    w = torch.arange(width, dtype=torch.float32, device=device) + bias
    if norm:
        h, w = h / height, w / width
    gy, gx = torch.meshgrid(h, w, indexing="ij")
    return torch.stack([gy, gx], dim=-1)


def default_boxes(
    shapes: Sequence[int],
    scales: Sequence[float],
    aspect_ratios: Sequence[Sequence[float]],
    device: torch.device | str | None = None,
) -> list[torch.Tensor]:
    """SSD default (anchor) boxes, one ``(H, W, A, 4)`` float32 tensor per
    scale (boxes.py:226-255): per cell the (h, w) pairs (s, s),
    (sqrt(s s'), sqrt(s s')), then (s sqrt(ar), s / sqrt(ar)) and its
    transpose for each aspect ratio. The centre comes from :func:`make_grid`,
    which yields (y, x), and the reference concatenates [centre, hw], so
    anchor[..., 0] is the y-ish coordinate: that layout is kept bit for bit
    (it is self-consistent on square grids, see ``decode_ssd_boxes``). The
    boxes are computed on ``device`` (constants enter as fills, nothing is
    copied from the host)."""
    out = []
    for ind, (shape, ars) in enumerate(zip(shapes, aspect_ratios)):
        centers = make_grid(shape, shape, bias=0.5, norm=True, device=device)  # (H, W, 2)
        s = float(scales[ind])
        g = math.sqrt(float(scales[ind]) * float(scales[ind + 1]))
        hw_pairs = [(s, s), (g, g)]
        for ar in ars:
            r = math.sqrt(ar)
            hw_pairs += [(s * r, s / r), (s / r, s * r)]
        num_a = len(hw_pairs)
        fill = lambda v: torch.full((), v, dtype=torch.float32, device=device)
        hw = torch.stack([torch.stack([fill(h), fill(w)]) for h, w in hw_pairs])  # (A, 2)
        out.append(torch.cat([centers[:, :, None, :].expand(shape, shape, num_a, 2),
                              hw[None, None].expand(shape, shape, num_a, 2)], dim=-1))
    return out


def clip_boxes_to_window(boxes_cxcyhw: torch.Tensor, window_xyxy: tuple, origin_hw: tuple) -> torch.Tensor:
    """Re-clip cxcyhw pixel boxes into a crop window (boxes.py:258-293):
    corners clamped into the window ``(min_x, min_y, max_x, max_y)``, then
    back to cxcyhw clipped into the original canvas ``(H, W)``; coordinates
    stay in the original frame."""
    min_x, min_y, max_x, max_y = window_xyxy
    h_lim, w_lim = origin_hw
    cx, cy, h, w = boxes_cxcyhw.unbind(-1)
    x1 = torch.clamp(torch.clamp(cx - w / 2, min=0.0), max=max_x)
    y1 = torch.clamp(torch.clamp(cy - h / 2, min=0.0), max=max_y)
    x2 = torch.clamp(torch.clamp(cx + w / 2, max=w_lim), min=min_x)
    y2 = torch.clamp(torch.clamp(cy + h / 2, max=h_lim), min=min_y)
    return torch.stack([
        torch.clamp((x1 + x2) / 2, 0.0, w_lim),
        torch.clamp((y1 + y2) / 2, 0.0, h_lim),
        torch.clamp(y2 - y1, 0.0, h_lim),
        torch.clamp(x2 - x1, 0.0, w_lim),
    ], dim=-1)
