from .boxes import box_l1_size, cxcyhw_to_xyxy
from .embeddings import inverse_sigmoid, sine_embed_centers, sine_position_map

__all__ = [
    "box_l1_size",
    "cxcyhw_to_xyxy",
    "inverse_sigmoid",
    "sine_embed_centers",
    "sine_position_map",
]
