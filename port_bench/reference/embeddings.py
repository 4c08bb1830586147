"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/geometry/embeddings.py`` l.1-82, its kernels replaced by their plain versions and its data-parallel paths left out.]

Sine positional embeddings and the logit helper (port of
``object_detection_destr_tpu/geometry/embeddings.py``).

The map encoding returns ``(B, H, W, C)`` (NHWC), as the JAX package does.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sine_position_map", "sine_embed_centers", "inverse_sigmoid"]


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """stack(sin(pos[..., 0::2]), cos(pos[..., 1::2])) interleaved on the last
    axis (position_encoding_cdetr.py:56-61, positional_embedding.py:31-36)."""
    sin = torch.sin(pos[..., 0::2])
    cos = torch.cos(pos[..., 1::2])
    return torch.stack([sin, cos], dim=-1).flatten(-2)


def sine_position_map(
    valid_mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Mask-aware 2-D sine position encoding over a feature map.

    Args:
        valid_mask: (B, H, W) bool, True = real pixel.

    Returns:
        (B, H, W, 2 * num_pos_feats) float32, y-embedding first then x
        (position_encoding_cdetr.py:62).
    """
    if scale is None:
        scale = 2 * math.pi
    not_mask = valid_mask.to(torch.float32)
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=valid_mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)

    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_embed_centers(centers: torch.Tensor, d_model: int = 512) -> torch.Tensor:
    """Sine/cos embedding of (cx, cy) query centers into ``d_model`` dims,
    concatenated as [y_half ‖ x_half] (positional_embedding.py:6-39).

    Args:
        centers: (..., >=2) — only the first two components are used.
    """
    scale = 2 * math.pi
    half = d_model // 2
    dim_t = torch.arange(half, dtype=torch.float32, device=centers.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)

    x_embed = centers[..., 0] * scale
    y_embed = centers[..., 1] * scale
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def inverse_sigmoid(x: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """logit(x) with the JAX package's double clamp (embeddings.py:98-107):
    x is clamped at eps, and so is the log argument, so the result stays
    finite at x == 1."""
    x = torch.clamp(x, min=epsilon)
    return -torch.log(torch.clamp(1.0 / x - 1.0, min=epsilon))
