"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/models/destr/pair_attention.py`` l.1-101, its kernels replaced by their plain versions and its data-parallel paths left out.]

Pair self-attention, DESTR's decoder op (port of
``object_detection_destr_tpu/models/destr/pair_attention.py``).

Each query is paired with the query whose box has the highest IoU with it,
the pair is ordered larger-box-left, and attention runs over the concatenated
pair features. The JAX package gathers with one-hot matmuls for the TPU's
matrix unit; here a plain ``torch.gather`` selects the same rows.
"""

from __future__ import annotations

import torch

from .boxes import box_l1_size, cxcyhw_to_xyxy

__all__ = ["get_pairs", "pair_self_attention"]


def get_pairs(centers_cxcyhw: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """IoU-argmax pairing with L1-size ordering (pair_attention.py:38-69).

    The intersection is *not* clamped at zero, as in the reference, and
    ``argmax`` takes the first maximum.

    Returns:
        (B, S, 2) int64 — ordered (left, right) query indices per query.
    """
    b, s, _ = centers_cxcyhw.shape
    boxes = cxcyhw_to_xyxy(centers_cxcyhw)
    b1 = boxes[:, :, None, :]
    b2 = boxes[:, None, :, :]
    inter_wh = torch.minimum(b1[..., 2:], b2[..., 2:]) - torch.maximum(b1[..., :2], b2[..., :2])
    inter_area = inter_wh[..., 0] * inter_wh[..., 1]
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    union = area[:, :, None] + area[:, None, :] - inter_area
    iou = inter_area / (union + epsilon) - torch.eye(s, dtype=boxes.dtype, device=boxes.device)

    partner = torch.argmax(iou, dim=-1)  # (B, S)
    own = torch.arange(s, device=boxes.device).expand(b, s)
    l1 = box_l1_size(boxes)
    partner_l1 = torch.gather(l1, 1, partner)
    own_first = l1 >= partner_l1  # larger box goes left
    left = torch.where(own_first, own, partner)
    right = torch.where(own_first, partner, own)
    return torch.stack([left, right], dim=-1)


def _gather_queries(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (B, h, S, d) along S with (B, S) indices."""
    b, h, s, d = t.shape
    return torch.gather(t, 2, idx[:, None, :, None].expand(b, h, s, d))


def pair_self_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    centers_cxcyhw: torch.Tensor,
    *,
    pair_mode: str = "reference",
    pair_output_mode: str = "reference",
) -> torch.Tensor:
    """Args:
        query/key/value: (B, h, S, d) pre-split heads.
        centers_cxcyhw: (B, S, 4) current box predictions (pairing signal).

    Returns:
        (B, S, h * d), heads merged (pair_attention.py:87-139).
    """
    b, h, s, d = query.shape
    pairs = get_pairs(centers_cxcyhw)
    left, right = pairs[..., 0], pairs[..., 1]

    ql, kl, vl = (_gather_queries(t, left) for t in (query, key, value))
    qr, kr, vr = (_gather_queries(t, right) for t in (query, key, value))

    a2 = torch.matmul(ql, kl.transpose(-1, -2)) + torch.matmul(qr, kr.transpose(-1, -2))
    # a fill, not a copy from the host: a CUDA graph can capture it
    inv_scale = 1.0 / torch.sqrt(torch.full((), 2 * d, dtype=a2.dtype, device=a2.device))
    if pair_mode == "paper":
        attn = torch.softmax(a2 * inv_scale, dim=-1)
    else:  # reference: softmax first, then scale the probabilities
        attn = torch.softmax(a2, dim=-1) * inv_scale

    own = torch.arange(s, device=query.device)
    own_is_left = left == own  # (B, S)
    own_is_right = right == own

    if pair_output_mode == "paper":
        o_l = torch.matmul(attn, vl).transpose(1, 2).reshape(b, s, h * d)
        o_r = torch.matmul(attn, vr).transpose(1, 2).reshape(b, s, h * d)
        return torch.where(own_is_left[..., None], o_l, 0.0) + torch.where(
            own_is_right[..., None], o_r, 0.0
        )

    # reference flatten order (B,h,S,2d) -> (B,S,h*2d) -> (B,S,2,h*d):
    # slot 0 = heads [0, h/2), slot 1 = heads [h/2, h), each with l‖r halves
    v_pair = torch.cat([vl, vr], dim=-1)  # (B, h, S, 2d)
    o2 = torch.matmul(attn, v_pair).transpose(1, 2).reshape(b, s, 2, h * d)
    keep = torch.stack([own_is_left, own_is_right], dim=-1)  # (B, S, 2)
    return torch.where(keep[..., None], o2, 0.0).sum(dim=2)
