"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/ops/focal.py`` l.1-43, its kernels replaced by their plain versions and its data-parallel paths left out.]

Sigmoid focal loss and the matcher's focal cost terms (port of
``object_detection_destr_tpu/ops/focal.py``)."""

from __future__ import annotations

import torch

__all__ = ["sigmoid_focal_loss", "focal_cost_terms"]


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy with logits (focal.py:18-20)."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def sigmoid_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    num_boxes,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Focal loss, mean over the class axis, sum over boxes, / num_boxes
    (focal.py:23-51). logits/targets: (..., N, C)."""
    prob = torch.sigmoid(logits)
    targets = targets.to(logits.dtype)
    ce = _bce_with_logits(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.mean(-1).sum(-1) / num_boxes


def focal_cost_terms(
    probs: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0, eps: float = 1e-8
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos_cost, neg_cost) per class for the Hungarian class cost
    (focal.py:54-65): ``neg = (1-a) p^g (-log(1-p+eps))``,
    ``pos = a (1-p)^g (-log(p+eps))``."""
    neg = (1 - alpha) * probs**gamma * (-torch.log(1 - probs + eps))
    pos = alpha * (1 - probs) ** gamma * (-torch.log(probs + eps))
    return pos, neg
