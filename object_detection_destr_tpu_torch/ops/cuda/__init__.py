"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

The head-major public ``flash_attention`` is exported by ``ops`` and not
here: the name is this package's submodule ``flash_attention``."""

from .auction import (
    auction_kernel,
    fused_auction,
    hungarian_match_fused,
    hungarian_match_fused_reference,
    solve_auction,
)
from .flash_attention import (
    backward_plan,
    flash_attention_bwd,
    flash_attention_dkv,
    flash_attention_dkv_reference,
    flash_attention_dq,
    flash_attention_dq_reference,
    flash_attention_fwd,
    flash_attention_packed,
    flash_attention_packed_backward_reference,
    flash_attention_packed_reference,
    flash_attention_reference,
    flash_attention_trainable,
    flash_attention_unpacked_dkv,
    flash_attention_unpacked_dkv_reference,
    flash_attention_unpacked_dq,
    flash_attention_unpacked_dq_reference,
    flash_attention_unpacked_fwd,
)

__all__ = [
    "auction_kernel",
    "backward_plan",
    "flash_attention_bwd",
    "flash_attention_dkv",
    "flash_attention_dkv_reference",
    "flash_attention_dq",
    "flash_attention_dq_reference",
    "flash_attention_fwd",
    "flash_attention_packed",
    "flash_attention_packed_backward_reference",
    "flash_attention_packed_reference",
    "flash_attention_reference",
    "flash_attention_trainable",
    "flash_attention_unpacked_dkv",
    "flash_attention_unpacked_dkv_reference",
    "flash_attention_unpacked_dq",
    "flash_attention_unpacked_dq_reference",
    "flash_attention_unpacked_fwd",
    "fused_auction",
    "hungarian_match_fused",
    "hungarian_match_fused_reference",
    "solve_auction",
]
