"""Non-maximum suppression with static shapes (port of
``object_detection_destr_tpu/ops/nms.py``, l.1-82).

* :func:`nms_triangular`: the reference's rule. Sort by score; keep box i
  iff every higher-scored valid box has IoU < thresh with it (an
  upper-triangular mask), so a box that is itself suppressed still
  suppresses.
* :func:`nms_greedy`: textbook greedy NMS, a fixed loop of S steps over
  device tensors (a suppressed box cannot suppress).

Both return the score order and a keep mask in that order instead of ragged
lists, and take any leading batch dimensions: ``(..., S, 4)`` boxes and
``(..., S)`` scores. The sort is stable (``jnp.argsort`` is): equal scores
keep ascending index order.
"""

from __future__ import annotations

import torch

from ..geometry.boxes import pairwise_iou

__all__ = ["nms_triangular", "nms_greedy"]


def _sort_by_score(boxes_xyxy: torch.Tensor, scores: torch.Tensor, score_thresh: float):
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.gather(boxes_xyxy, -2, order[..., None].expand(*order.shape, 4))
    valid = torch.gather(scores, -1, order) >= score_thresh
    return boxes_s, valid, order


def nms_triangular(
    boxes_xyxy: torch.Tensor,
    scores: torch.Tensor,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference-rule NMS (nms.py:37-58).

    Returns:
        (order, keep): (..., S) int64 indices into the original order, score
        descending, and (..., S) bool in that order; only positions with
        ``keep`` are detections.
    """
    boxes_s, valid, order = _sort_by_score(boxes_xyxy, scores, score_thresh)
    iou = pairwise_iou(boxes_s, boxes_s)
    s = scores.shape[-1]
    tri = torch.triu(torch.ones((s, s), dtype=torch.bool, device=scores.device), diagonal=1)
    suppress = tri & (iou >= iou_thresh) & valid[..., :, None]  # row j suppresses col i for j < i
    keep = ~suppress.any(dim=-2) & valid
    return order, keep


def nms_greedy(
    boxes_xyxy: torch.Tensor,
    scores: torch.Tensor,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential greedy NMS (nms.py:61-82): for i = 0 .. S-1 in score order,
    a kept box i drops every later box with IoU >= thresh. Returns
    (order, keep) as :func:`nms_triangular`."""
    boxes_s, keep, order = _sort_by_score(boxes_xyxy, scores, score_thresh)
    iou = pairwise_iou(boxes_s, boxes_s) >= iou_thresh
    s = scores.shape[-1]
    later = torch.arange(s, device=scores.device)
    for i in range(s):
        keep = keep & ~(iou[..., i, :] & (later > i) & keep[..., i : i + 1])
    return order, keep
