from .boxes import (
    box_l1_size,
    cxcyhw_to_xyxy,
    elementwise_ciou,
    elementwise_iou,
    flat_box_mask,
    pairwise_ciou,
    pairwise_iou,
    xyxy_to_cxcyhw,
)
from .embeddings import inverse_sigmoid, sine_embed_centers, sine_position_map

__all__ = [
    "box_l1_size",
    "cxcyhw_to_xyxy",
    "elementwise_ciou",
    "elementwise_iou",
    "flat_box_mask",
    "inverse_sigmoid",
    "pairwise_ciou",
    "pairwise_iou",
    "sine_embed_centers",
    "sine_position_map",
    "xyxy_to_cxcyhw",
]
