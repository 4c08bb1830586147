"""DESTR configuration (port of ``object_detection_destr_tpu/config.py:14-53``)
and the device rule shared by every entry point of the port.

The dataclass keeps the JAX package's field names and defaults so a config
carries across unchanged. Fields that only matter for training
(``dropout``, ``remat``, ``bn_axis_name``) are kept for that reason and are
ignored by the serving path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["DestrConfig", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class DestrConfig:
    """DESTR split-transformer config (reference defaults: arg_parser.py:14-137)."""

    hidden_dim: int = 256
    num_heads: int = 8
    num_encoder_blocks: int = 6
    num_decoder_blocks: int = 6
    top_k: int = 300
    num_cls: int = 2
    dropout: float = 0.3
    ffn_dim: int = 2048  # encoder FFN width (encoder_block.py:64)
    lambda_pair: float = 0.5  # self/pair attention blend (decoder_block.py:73)
    backbone: str = "resnet50"
    dilation: bool = False  # replace C5 stride with dilation (backbone.py:139-143)
    pos_embed: str = "sine"  # "sine" | "learned"
    pair_mode: str = "reference"  # "reference" | "paper"
    pair_output_mode: str = "reference"  # "reference" | "paper"
    # "float32" is what the server runs; "bfloat16" arrives with the
    # training slice and raises until then
    compute_dtype: str = "float32"
    remat: bool = False
    # head-packed attention through ops/cuda/flash_attention.py: "auto" and
    # True launch the CUDA kernel for CUDA tensors and run its plain PyTorch
    # version for CPU tensors; False takes ops/attention.py instead
    use_flash_attention: bool | str = "auto"
    bn_axis_name: Optional[str] = None


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: with no CUDA device this raises instead of
    carrying on quietly on the CPU. The CPU is used only when asked for.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
