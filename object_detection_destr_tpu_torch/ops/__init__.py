from .assignment import auction_assignment, batched_assignment, solve_auction
from .attention import combine_heads, multi_head_attention, scaled_dot_product_attention, split_heads
from .cuda.flash_attention import flash_attention, flash_attention_packed, flash_attention_trainable
from .focal import focal_cost_terms, sigmoid_focal_loss
from .nms import nms_greedy, nms_triangular
from .topk import masked_topk_with_recycle

__all__ = [
    "auction_assignment",
    "batched_assignment",
    "combine_heads",
    "flash_attention",
    "flash_attention_packed",
    "flash_attention_trainable",
    "focal_cost_terms",
    "masked_topk_with_recycle",
    "multi_head_attention",
    "nms_greedy",
    "nms_triangular",
    "scaled_dot_product_attention",
    "sigmoid_focal_loss",
    "solve_auction",
    "split_heads",
]
