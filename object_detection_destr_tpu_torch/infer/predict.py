"""DESTR post-processing (port of ``destr_predict``,
``object_detection_destr_tpu/infer/predict.py:30-61``).

DESTR is set prediction: no NMS. Scores are sigmoid class probabilities over
the foreground classes, sorted, and thresholded into a validity mask.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..geometry.boxes import cxcyhw_to_xyxy
from ..ops.topk import stable_topk

__all__ = ["destr_predict"]


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
