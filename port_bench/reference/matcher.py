"""The matcher of the training step in plain PyTorch: a frozen copy of
``object_detection_destr_tpu_torch/ops/cuda/auction.py`` l.106-253
(``solve_auction``, ``fused_cost_inputs``, ``matching_value_reference``,
``hungarian_match_fused_reference``: the fused auction kernel's function,
bid for bid) and of ``train/steps.py::_match_pair`` l.78-106 (both criteria
matched in one problem batch, the model's top-k rows and the mini-detector's
tokens padded to one row count)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .boxes import cxcyhw_to_xyxy, xyxy_to_cxcyhw
from .focal import focal_cost_terms

__all__ = ["hungarian_match_fused_reference", "match_pair", "solve_auction"]

BIG = 1e9


def solve_auction(
    value: torch.Tensor,
    col_valid: torch.Tensor,
    row_valid: torch.Tensor,
    eps_frac: float = 0.001,
    max_iters: int = 256,
    bids_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Args:
        value: (B, T, N) float32 benefits, -1e9 on rows that are not real.
        col_valid: (B, T) bool; row_valid: (B, N) bool.
        bids_out: optional (B,) integer tensor; the bids of every round
            (one a bidding column) are added to it, as the kernels count them.

    Returns:
        rows (B, T) int64, duplicate-free; rounds (B,) int64, the bidding
        rounds each problem ran.
    """
    b, t, n = value.shape
    dev = value.device
    value = value.float()
    real = row_valid[:, None, :] & col_valid[:, :, None]
    has_inv = (~col_valid).any(1)
    vmax = torch.where(real, value, -BIG).amax((1, 2))
    vmin = torch.where(real, value, BIG).amin((1, 2))
    vmax = torch.maximum(vmax, torch.where(has_inv, 0.0, -BIG))
    vmin = torch.minimum(vmin, torch.where(has_inv, 0.0, BIG))
    value_range = torch.clamp(vmax - vmin, min=1e-6)[:, None]  # (B, 1)
    eps = eps_frac * value_range

    prices = torch.zeros((b, n), dtype=torch.float32, device=dev)
    owner = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    roc = torch.full((b, t), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros(b, dtype=torch.int64, device=dev)
    cols = torch.arange(t, device=dev).expand(b, t)
    for _ in range(max_iters):
        bidding = (roc < 0) & col_valid
        active = bidding.any(1)
        if not bool(active.any()):
            break
        rounds += active
        if bids_out is not None:
            bids_out += bidding.sum(1).to(bids_out.dtype)
        net = value - prices[:, None, :]
        best_v, best_i = net.max(-1)  # first index of the maximum
        second_v = net.scatter(-1, best_i[..., None], -BIG).amax(-1)
        second_v = torch.maximum(second_v, best_v - value_range - 1.0)
        bid = best_v - second_v + eps
        bid_price = torch.where(bidding, prices.gather(1, best_i) + bid, -BIG)
        row_bids = torch.full((b, n), -BIG, device=dev).scatter_reduce(
            1, best_i, bid_price, "amax", include_self=True
        )
        got = row_bids > -BIG / 2
        top = bidding & (bid_price == row_bids.gather(1, best_i))
        win_col = torch.full((b, n), t, dtype=torch.int64, device=dev).scatter_reduce(
            1, best_i, torch.where(top, cols, t), "amin", include_self=True
        )
        bi, ni = (got & (owner >= 0)).nonzero(as_tuple=True)
        roc[bi, owner[bi, ni]] = -1  # evict the owners of rows that got bids
        bi, ni = got.nonzero(as_tuple=True)
        roc[bi, win_col[bi, ni]] = ni
        owner = torch.where(got, win_col, owner)
        prices = torch.where(got, row_bids, prices)

    free = torch.ones((b, n), dtype=torch.bool, device=dev)
    bi, ti = (roc >= 0).nonzero(as_tuple=True)
    free[bi, roc[bi, ti]] = False
    batch = torch.arange(b, device=dev)
    for j in (roc < 0).any(0).nonzero().flatten().tolist():
        cur = roc[:, j]
        needs = cur < 0
        pick = torch.where(free, value[:, j, :], -BIG).argmax(-1)
        roc[:, j] = torch.where(needs, pick, cur)
        free[batch[needs], pick[needs]] = False
    return roc, rounds



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
                                    max_iters: int = 256, bids_out: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch: (rows (B, T) int64, rounds (B,));
    ``bids_out`` as :func:`solve_auction` takes it."""
    row_valid = _row_valid(pred_logits, row_valid)
    pn, atan_p, atan_g = fused_cost_inputs(pred_logits, pred_boxes, tgt_boxes)
    value = matching_value_reference(pn, pred_boxes, atan_p, tgt_boxes, atan_g, tgt_labels,
                                     col_valid, row_valid, cost_class, cost_ciou)
    return solve_auction(value, col_valid, row_valid, eps_frac, max_iters, bids_out)


def match_pair(model_out: dict, det_out: dict, targets: dict):
    """(rows of the model's output, rows of the mini-detector's), one
    auction over both problems stacked on the batch axis."""
    b, n1 = model_out["pred_class"].shape[:2]
    n2 = det_out["pred_class"].shape[1]
    n = max(n1, n2)

    def pad_n(x, rows):
        return F.pad(x.detach().float(), (0, 0, 0, n - rows))

    logits = torch.cat([pad_n(model_out["pred_class"], n1), pad_n(det_out["pred_class"], n2)])
    boxes = torch.cat([pad_n(model_out["pred_boxes"], n1), pad_n(det_out["pred_boxes"], n2)])
    iota = torch.arange(n, device=logits.device)[None, :]
    row_valid = torch.cat([(iota < n1).expand(b, n), (iota < n2).expand(b, n)])
    twice = lambda t: torch.cat([t, t])
    rows, _ = hungarian_match_fused_reference(
        logits, boxes, twice(targets["boxes"].detach()), twice(targets["labels"]),
        twice(targets["valid"]), row_valid=row_valid,
    )
    return rows[:b], rows[b:]
