"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""

from .auction import fused_auction, hungarian_match_fused, hungarian_match_fused_reference
from .flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_packed,
    flash_attention_packed_backward_reference,
    flash_attention_packed_reference,
)

__all__ = [
    "flash_attention_bwd",
    "flash_attention_fwd",
    "flash_attention_packed",
    "flash_attention_packed_backward_reference",
    "flash_attention_packed_reference",
    "fused_auction",
    "hungarian_match_fused",
    "hungarian_match_fused_reference",
]
