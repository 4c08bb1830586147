"""Shared building blocks of the DESTR transformer (port of
``object_detection_destr_tpu/models/destr/layers.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import scaled_dot_product_attention, split_heads
from ...ops.cuda.flash_attention import flash_attention_packed

__all__ = ["Mlp", "MultiHeadAttention", "LearnedPositionEmbedding", "layer_norm"]


def layer_norm(features: int) -> nn.LayerNorm:
    """LayerNorm with flax's default eps of 1e-6 (torch's default is 1e-5)."""
    return nn.LayerNorm(features, eps=1e-6)


class LearnedPositionEmbedding(nn.Module):
    """Learned 2-D position embedding (layers.py:36-63): per pixel
    ``concat[col_embed(x), row_embed(y)]``, x first."""

    def __init__(self, num_pos_feats: int = 128, table_size: int = 50):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.row_embed = nn.Embedding(table_size, num_pos_feats)
        self.col_embed = nn.Embedding(table_size, num_pos_feats)

    def forward(self, h: int, w: int) -> torch.Tensor:
        """Returns (H, W, 2 * num_pos_feats)."""
        device = self.row_embed.weight.device
        x_emb = self.col_embed(torch.arange(w, device=device))  # (W, d)
        y_emb = self.row_embed(torch.arange(h, device=device))  # (H, d)
        d = self.num_pos_feats
        return torch.cat(
            [x_emb[None, :, :].expand(h, w, d), y_emb[:, None, :].expand(h, w, d)], dim=-1
        )


class Mlp(nn.Module):
    """Linear stack with ReLU between layers, none after the last
    (layers.py:66-83); layers are named ``fc{i}``."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.num_layers = len(features)
        for i, f in enumerate(features):
            self.add_module(f"fc{i}", nn.Linear(in_features, f))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Batch-first MHA with q/k/v/out projections (layers.py:86-137).

    ``use_flash`` routes the head-packed operands through the flash-attention
    wrapper (the CUDA kernel for CUDA tensors); otherwise heads are split and
    ops/attention.py computes the same function.
    """

    def __init__(self, hidden_dim: int, num_heads: int, use_flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.q_proj = nn.Linear(hidden_dim, hidden_dim)
        self.k_proj = nn.Linear(hidden_dim, hidden_dim)
        self.v_proj = nn.Linear(hidden_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        key_valid_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        if self.use_flash:
            out = flash_attention_packed(q, k, v, self.num_heads, key_valid_mask)
        else:
            h = self.num_heads
            out = scaled_dot_product_attention(
                split_heads(q, h), split_heads(k, h), split_heads(v, h),
                key_valid_mask=key_valid_mask,
            )
        return self.out_proj(out)
