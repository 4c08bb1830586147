"""The DESTR set criterion on one device (a frozen copy of
``object_detection_destr_tpu_torch/losses/criterion.py::set_criterion``
l.20-123, without the mesh's reduction), over the padded batch with masks.
The assignment ``rows`` comes from :mod:`.matcher`."""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from .boxes import cxcyhw_to_xyxy, elementwise_ciou, pairwise_ciou
from .focal import sigmoid_focal_loss

__all__ = ["set_criterion"]


def set_criterion(
    outputs: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    *,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    background_class: Optional[int] = None,
    ciou_mode: str = "elementwise",
    class_norm: str = "queries",
    rows: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """DETR-style set criterion.

    Args:
        outputs: {"pred_class": (B, N, C) logits, "pred_boxes": (B, N, 4) cxcyhw}.
        targets: {"boxes": (B, T, 4) xyxy, "labels": (B, T), "valid": (B, T)}.
        background_class: label of unmatched queries (default C - 1).
        ciou_mode: "elementwise" (matched pairs) or "reference" (mean over
            the n_match x n_match pairwise matrix, criterion.py:82-89 of the
            reference).
        class_norm: "queries" divides the per-image focal sum by N, "boxes"
            by the image's valid GT count (min 1).
        rows: the (B, T) assignment.

    Returns:
        {"class", "bbox", "ciou"} scalars: class averaged over every image,
        bbox/ciou over images with at least one match (0 when none).
    """
    pred_logits = outputs["pred_class"].float()
    pred_boxes = outputs["pred_boxes"].float()
    b, n, num_cls = pred_logits.shape
    tgt_valid = targets["valid"]
    labels = targets["labels"].long()
    if background_class is None:
        background_class = num_cls - 1
    rows = rows.detach().long()

    # ---- class loss: matched labels scattered to their query slots; rows
    # past N (an unmatchable target parked on a padding row) are dropped
    scatter_labels = torch.where(tgt_valid, labels, background_class)
    in_range = rows < n
    query_labels = torch.full((b, n + 1), background_class, dtype=torch.long, device=rows.device)
    query_labels.scatter_(1, torch.where(in_range, rows, n), scatter_labels)
    one_hot = F.one_hot(query_labels[:, :n], num_cls).to(pred_logits.dtype)
    if class_norm == "boxes":
        class_denom = torch.clamp(tgt_valid.sum(-1), min=1).float()
    elif class_norm == "queries":
        class_denom = float(n)
    else:
        raise ValueError(f"class_norm={class_norm!r}")
    class_loss = sigmoid_focal_loss(pred_logits, one_hot, class_denom, focal_alpha, focal_gamma)

    # ---- box losses over matched pairs
    matched = tgt_valid & in_range
    pred_xyxy = cxcyhw_to_xyxy(pred_boxes)
    matched_pred = pred_xyxy.gather(1, torch.clamp(rows, max=n - 1)[..., None].expand(b, rows.shape[1], 4))
    gt_xyxy = targets["boxes"].float()
    n_match = matched.sum(-1)
    denom = torch.clamp(n_match, min=1).float()
    mf = matched.to(pred_logits.dtype)
    l1 = ((matched_pred - gt_xyxy).abs() * mf[..., None]).sum((-1, -2)) / (4.0 * denom)
    if ciou_mode == "reference":
        pair_valid = matched[:, :, None] & matched[:, None, :]
        ciou_mat = pairwise_ciou(matched_pred, gt_xyxy)
        ciou = torch.where(pair_valid, ciou_mat, 0.0).sum((-1, -2)) / (denom * denom)
    elif ciou_mode == "elementwise":
        ciou = (elementwise_ciou(matched_pred, gt_xyxy) * mf).sum(-1) / denom
    else:
        raise ValueError(f"ciou_mode={ciou_mode!r}")

    has_match = (n_match > 0).float()
    num_with = torch.clamp(has_match.sum(), min=1.0)
    return {
        "class": class_loss.mean(),
        "bbox": (l1 * has_match).sum() / num_with,
        "ciou": (ciou * has_match).sum() / num_with,
    }
