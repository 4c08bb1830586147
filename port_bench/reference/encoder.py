"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/models/destr/encoder.py`` l.1-77, its kernels replaced by their plain versions and its data-parallel paths left out.]

DESTR transformer encoder over H*W image tokens (port of
``object_detection_destr_tpu/models/destr/encoder.py``).

A shared ``pos_scale`` MLP modulates the positional embedding per block, and
one shared outer LayerNorm wraps every block with an extra residual. Every
LayerNorm has eps 1e-6, the flax default (encoder.py:56, :62, :87).
Dropout (rate ``dropout``) sits where the JAX block has it (encoder.py:48-62):
on the attention probabilities inside the attention call, after the
attention, after the FFN's ReLU and after its output; it is active only when
a :class:`~.layers.DropoutRng` is passed. With ``remat`` each block runs under
activation checkpointing (:func:`~.layers.checkpointed`, ``nn.remat`` at
encoder.py:78) while gradients are recorded.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import DropoutRng, Mlp, MultiHeadAttention, checkpointed, dropout, layer_norm

__all__ = ["Encoder", "EncoderBlock"]


class EncoderBlock(nn.Module):
    def __init__(self, hidden_dim: int = 256, num_heads: int = 8, ffn_dim: int = 2048,
                 use_flash: bool = False, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(hidden_dim, num_heads, use_flash=use_flash,
                                            dropout=dropout)
        self.norm1 = layer_norm(hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, hidden_dim)
        self.norm2 = layer_norm(hidden_dim)

    def forward(self, x: torch.Tensor, pos_embed: torch.Tensor, valid_mask: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rate = self.dropout
        qk = x + pos_embed
        attn = self.self_attn(qk, qk, x, key_valid_mask=valid_mask, rng=rng)
        x = self.norm1(x + dropout(attn, rate, rng))
        h = dropout(F.relu(self.fc1(x)), rate, rng)
        x = x + dropout(self.fc2(h), rate, rng)
        return self.norm2(x)


class Encoder(nn.Module):
    def __init__(self, hidden_dim: int = 256, num_heads: int = 8, ffn_dim: int = 2048,
                 num_blocks: int = 6, use_flash: bool = False, dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.num_blocks = num_blocks
        self.remat = remat
        self.pos_scale = Mlp(hidden_dim, [hidden_dim, hidden_dim])
        for i in range(num_blocks):
            self.add_module(
                f"block{i}", EncoderBlock(hidden_dim, num_heads, ffn_dim, use_flash, dropout)
            )
        self.outer_norm = layer_norm(hidden_dim)

    def forward(self, tokens: torch.Tensor, pos_embed: torch.Tensor,
                valid_mask: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """tokens/pos_embed: (B, HW, C); valid_mask: (B, HW) True = real."""
        x = tokens
        for i in range(self.num_blocks):
            scale = self.pos_scale(x)
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                tmp = checkpointed(block, rng, x, pos_embed * scale, valid_mask)
            else:
                tmp = block(x, pos_embed * scale, valid_mask, rng)
            x = self.outer_norm(x + tmp)
        return x
