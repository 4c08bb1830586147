from .boxes import (
    box_l1_size,
    clip_boxes_to_window,
    cxcyhw_to_xyxy,
    default_boxes,
    elementwise_ciou,
    elementwise_iou,
    flat_box_mask,
    make_grid,
    pairwise_ciou,
    pairwise_iou,
    xywh_to_xyxy,
    xyxy_to_cxcyhw,
)
from .embeddings import inverse_sigmoid, sine_embed_centers, sine_position_map

__all__ = [
    "box_l1_size",
    "clip_boxes_to_window",
    "cxcyhw_to_xyxy",
    "default_boxes",
    "elementwise_ciou",
    "elementwise_iou",
    "flat_box_mask",
    "inverse_sigmoid",
    "make_grid",
    "pairwise_ciou",
    "pairwise_iou",
    "sine_embed_centers",
    "sine_position_map",
    "xywh_to_xyxy",
    "xyxy_to_cxcyhw",
]
