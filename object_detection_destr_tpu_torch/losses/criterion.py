"""The DESTR set criterion and the SSD criterion (port of
``object_detection_destr_tpu/losses/criterion.py``: ``set_criterion``
l.28-161, ``ssd_criterion`` l.164-284), computed over the padded batch with
masks, no host loops and nothing read back to the host."""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from ..geometry.boxes import cxcyhw_to_xyxy, elementwise_ciou, pairwise_ciou
from ..ops.focal import sigmoid_focal_loss
from .matcher import decode_ssd_boxes, hungarian_match, ssd_match

__all__ = ["set_criterion", "ssd_criterion"]


def set_criterion(
    outputs: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    *,
    cost_class: float = 1.0,
    cost_bbox: float = 0.0,
    cost_ciou: float = 1.0,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    background_class: Optional[int] = None,
    ciou_mode: str = "elementwise",
    class_norm: str = "queries",
    rows: Optional[torch.Tensor] = None,
    mesh=None,
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
        rows: optional precomputed (B, T) assignment.
        mesh: the data-parallel mesh (``parallel.Mesh``) when this rank's
            rows of the global batch are given (JAX ``axis_name``,
            criterion.py:146-160): the batch reductions then span the whole
            batch, in one all-reduce. Each value is the GLOBAL loss, and its
            gradient is this rank's share of the global loss' gradient (its
            numerators over the global, detached denominators), so the sum
            of the ranks' gradients is the global batch's.

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
    if rows is None:
        rows = hungarian_match(outputs, targets, cost_class=cost_class, cost_bbox=cost_bbox,
                               cost_ciou=cost_ciou)
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
    if mesh is None:
        num_with = torch.clamp(has_match.sum(), min=1.0)
        return {
            "class": class_loss.mean(),
            "bbox": (l1 * has_match).sum() / num_with,
            "ciou": (ciou * has_match).sum() / num_with,
        }
    # num_with is the psum of has_match, class the pmean of the shard means,
    # bbox and ciou psummed numerators over the global num_with
    local = torch.stack([has_match.sum(), class_loss.mean(), (l1 * has_match).sum(), (ciou * has_match).sum()])
    total = mesh.all_reduce_(local.detach().clone())
    num_with = torch.clamp(total[0], min=1.0)
    shares = {"class": local[1] / mesh.size, "bbox": local[2] / num_with, "ciou": local[3] / num_with}
    values = {"class": total[1] / mesh.size, "bbox": total[2] / num_with, "ciou": total[3] / num_with}
    # the value is the global one, bit for bit on every rank (the trainer's
    # best-checkpoint choice must agree across ranks); the gradient is the share's
    return {k: values[k] + (shares[k] - shares[k].detach()) for k in shares}


def _flatten_scales(per_scale: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(B, H, W, A, D)] x 6 -> (B, S, D), scale-major (criterion.py:164-168)."""
    return torch.cat([t.reshape(t.shape[0], -1, t.shape[-1]) for t in per_scale], dim=1)


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Huber with beta 1 (criterion.py:171-174)."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def ssd_criterion(
    outputs: Mapping[str, Sequence[torch.Tensor]],
    targets: Mapping[str, torch.Tensor],
    anchors: torch.Tensor,
    *,
    loss_coef: float = 0.5,
    neg_pos_ratio: int = 3,
    iou_thresh: float = 0.5,
    eps: float = 1e-8,
    mining: str = "reference",
) -> dict[str, torch.Tensor]:
    """SSD criterion: matching, smooth-L1 localization and the class loss with
    hard-negative mining (criterion.py:177-284); every image contributes and
    the batch is averaged.

    Args:
        outputs: {"boxes": [6 x (B, H, W, A, 4)], "conf": [6 x (B, H, W, A, C+1)]}.
        targets: {"boxes": (B, T, 4) cxcyhw, "labels": (B, T), "valid": (B, T)}.
        anchors: (S, 4) flattened default boxes (``train.steps.flat_anchors``).
        loss_coef: ``loss = coef * class + (1 - coef) * local``.
        mining: "reference" keeps the negatives of highest background
            log-probability (the reference's inverted sort: the easiest);
            "paper" the lowest (the hardest, the SSD paper's rule). Either
            keeps ``min(neg_pos_ratio * positives, negatives)`` of them.

    The localization terms stay per coordinate in a (B, T, S) layout and the
    positive log-likelihoods are a batched product of the targets' one-hot
    labels with the log-softmax, never a (B, S, T, 4) tensor; the mined
    negatives are a rank mask over the sorted background log-probabilities,
    so the step reads nothing back to the host. Their sum does not depend on
    how equal values are ordered.

    Returns:
        {"loss", "class", "local"} scalars.
    """
    pred_boxes = _flatten_scales(outputs["boxes"]).float()  # (B, S, 4)
    logits = _flatten_scales(outputs["conf"]).float()  # (B, S, C+1)
    gt = targets["boxes"].float()  # (B, T, 4) cxcyhw
    gt_valid = targets["valid"]
    labels = targets["labels"].long()

    decoded_xyxy = cxcyhw_to_xyxy(decode_ssd_boxes(pred_boxes.detach(), anchors))
    match, positive = ssd_match(decoded_xyxy, cxcyhw_to_xyxy(gt), gt_valid, iou_thresh)
    n_pairs = match.sum(dim=(-1, -2))  # (B,)

    # ---- localization: smooth-L1 on the encoded offsets, (B, T, S)
    match_t = match.transpose(1, 2)
    acx, acy, ah, aw = (anchors[:, i][None, None, :] for i in range(4))  # (1, 1, S)
    gc = lambda i: gt[..., i][..., None]  # (B, T, 1)
    pc = lambda i: pred_boxes[..., i][:, None, :]  # (B, 1, S)
    ah_safe, aw_safe = torch.clamp(ah, min=eps), torch.clamp(aw, min=eps)
    ratio_h = torch.where(match_t, gc(2) / ah_safe, 1.0)
    ratio_w = torch.where(match_t, gc(3) / aw_safe, 1.0)
    local_el = (
        _smooth_l1(pc(0) - (gc(0) - acx) / aw_safe)
        + _smooth_l1(pc(1) - (gc(1) - acy) / ah_safe)
        + _smooth_l1(pc(2) - torch.log(torch.clamp(ratio_h, min=eps)))
        + _smooth_l1(pc(3) - torch.log(torch.clamp(ratio_w, min=eps)))
    )
    local_per_img = torch.where(match_t, local_el, 0.0).sum(dim=(-1, -2)) / torch.clamp(4.0 * n_pairs, min=1.0)

    # ---- classification: positive log-likelihood + mined negatives
    log_conf = F.log_softmax(logits, dim=-1)  # (B, S, C+1)
    onehot = F.one_hot(labels, log_conf.shape[-1]).to(log_conf.dtype)  # (B, T, C+1)
    pos_ll = torch.bmm(onehot, log_conf.transpose(1, 2))  # (B, T, S)
    pos_term = torch.where(match_t, pos_ll, 0.0).sum(dim=(-1, -2))

    n_pos = positive.sum(dim=-1)
    bg_ll = log_conf[..., -1]  # (B, S)
    if mining == "paper":
        neg_sorted = torch.sort(torch.where(positive, torch.inf, bg_ll), dim=-1).values
    elif mining == "reference":
        neg_sorted = torch.sort(torch.where(positive, -torch.inf, bg_ll), dim=-1, descending=True).values
    else:
        raise ValueError(f"mining={mining!r}")
    s = neg_sorted.shape[-1]
    keep_n = torch.minimum(neg_pos_ratio * n_pos, s - n_pos)  # (B,)
    neg_keep = torch.arange(s, device=bg_ll.device)[None, :] < keep_n[:, None]
    neg_term = torch.where(neg_keep, neg_sorted, 0.0).sum(dim=-1)

    local = local_per_img.mean()
    class_ = (-(pos_term + neg_term)).mean()
    return {"loss": loss_coef * class_ + (1.0 - loss_coef) * local, "class": class_, "local": local}
