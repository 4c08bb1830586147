"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""

from .flash_attention import (
    flash_attention_fwd,
    flash_attention_packed,
    flash_attention_packed_reference,
)

__all__ = [
    "flash_attention_fwd",
    "flash_attention_packed",
    "flash_attention_packed_reference",
]
