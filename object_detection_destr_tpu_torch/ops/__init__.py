from .attention import combine_heads, scaled_dot_product_attention, split_heads
from .topk import masked_topk_with_recycle

__all__ = [
    "combine_heads",
    "masked_topk_with_recycle",
    "scaled_dot_product_attention",
    "split_heads",
]
