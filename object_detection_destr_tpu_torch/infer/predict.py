"""Post-processing for DESTR and SSD (port of
``object_detection_destr_tpu/infer/predict.py``: ``destr_predict`` l.30-61,
``ssd_predict`` l.63-111).

DESTR is set prediction: no NMS. Scores are sigmoid class probabilities over
the foreground classes, sorted, and thresholded into a validity mask. SSD
decodes its offsets against the default boxes, scores each box by its best
foreground softmax probability, keeps the top ``max_dets`` and suppresses
them per image with the reference's triangular rule (``ops/nms.py``).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..geometry.boxes import cxcyhw_to_xyxy
from ..losses.criterion import _flatten_scales
from ..losses.matcher import decode_ssd_boxes
from ..ops.nms import nms_triangular
from ..ops.topk import stable_topk

__all__ = ["destr_predict", "ssd_predict"]


def destr_predict(
    outputs: Mapping[str, torch.Tensor],
    score_thresh: float = 0.5,
    max_dets: int = 300,
) -> dict[str, torch.Tensor]:
    """Args:
        outputs: {"pred_class": (B, K, C) logits, "pred_boxes": (B, K, 4) cxcyhw}.

    Returns:
        {"boxes": (B, D, 4) xyxy, "scores": (B, D), "labels": (B, D),
         "valid": (B, D)} with D = min(max_dets, K), score-sorted (ties by
        ascending index, as ``lax.top_k``).
    """
    probs = torch.sigmoid(outputs["pred_class"])
    # last channel is background (criterion.py:40-45's dummy class)
    fg = probs[..., :-1] if probs.shape[-1] > 1 else probs
    scores, labels = fg.max(dim=-1)
    boxes = cxcyhw_to_xyxy(outputs["pred_boxes"])

    d = min(max_dets, scores.shape[-1])
    top_s, top_i = stable_topk(scores, d)
    return {
        "boxes": torch.gather(boxes, 1, top_i[..., None].expand(*top_i.shape, 4)),
        "scores": top_s,
        "labels": torch.gather(labels, 1, top_i),
        "valid": top_s >= score_thresh,
    }


def ssd_predict(
    outputs: Mapping[str, Sequence[torch.Tensor]],
    anchors: torch.Tensor,
    score_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    max_dets: int = 200,
) -> dict[str, torch.Tensor]:
    """Decode + reference-rule NMS for SSD.

    Args:
        outputs: {"boxes": [6 x (B, H, W, A, 4)], "conf": [6 x (B, H, W, A, C+1)]}.
        anchors: (S, 4) flattened default boxes (``train.steps.flat_anchors``).

    Returns:
        {"boxes": (B, D, 4) xyxy, "scores": (B, D), "labels": (B, D),
         "valid": (B, D)}, D = min(max_dets, S), score-sorted (ties by
        ascending index, as ``lax.top_k``); ``valid`` is NMS's keep mask
        mapped back to that order.
    """
    pred_boxes = _flatten_scales(outputs["boxes"]).float()  # (B, S, 4)
    conf = torch.softmax(_flatten_scales(outputs["conf"]).float(), dim=-1)  # (B, S, C+1)
    decoded = cxcyhw_to_xyxy(decode_ssd_boxes(pred_boxes, anchors))
    scores, labels = conf[..., :-1].max(dim=-1)  # best foreground class (background is last)

    d = min(max_dets, scores.shape[-1])
    top_s, top_i = stable_topk(scores, d)
    boxes_k = torch.gather(decoded, 1, top_i[..., None].expand(*top_i.shape, 4))
    order, keep = nms_triangular(boxes_k, top_s, iou_thresh=iou_thresh, score_thresh=score_thresh)
    # back to score order: keep[..., j] belongs to position order[..., j]
    valid = torch.zeros_like(keep).scatter_(-1, order, keep)
    return {"boxes": boxes_k, "scores": top_s, "labels": torch.gather(labels, 1, top_i), "valid": valid}
