"""Box geometry (port of ``object_detection_destr_tpu/geometry/boxes.py``).

Boxes are normalized to [0, 1]; ``cxcyhw`` is (center_x, center_y, height,
width), h before w, as the reference has it (bbox_utils.py:33-63).
"""

from __future__ import annotations

import torch

__all__ = ["cxcyhw_to_xyxy", "box_l1_size"]


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


def box_l1_size(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """|w| + |h| per box — the pair-ordering key of DESTR pair attention
    (boxes.py:191-196)."""
    return torch.abs(boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) + torch.abs(
        boxes_xyxy[..., 3] - boxes_xyxy[..., 1]
    )
