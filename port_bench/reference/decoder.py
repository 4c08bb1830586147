"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/models/destr/decoder.py`` l.1-221, its kernels replaced by their plain versions and its data-parallel paths left out.]

DESTR split decoder: pair self-attention, split cls/reg cross-attention
and per-layer box refinement (port of
``object_detection_destr_tpu/models/destr/decoder.py``).

Two attention calls per block go through the flash-attention wrapper: the
plain self-attention branch (h heads) and one merged cross-attention call for
both the cls and reg branches (their query sets stacked along the sequence
axis, decoder.py:175-188). Dropout sits where the JAX blocks have it
(decoder.py:65-92, 133-153): inside both attention calls, on the
self-attention and pair-attention outputs, on the cross-attention output
and the branch FFN; it is active only when a :class:`~.layers.DropoutRng`
is passed. Shared heads run in float32 (:func:`~.layers.f32_head`). With
``remat`` each block runs under activation checkpointing
(:func:`~.layers.checkpointed`, ``nn.remat`` at decoder.py:219-221) while
gradients are recorded.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .embeddings import inverse_sigmoid, sine_embed_centers
from .attention import combine_heads, scaled_dot_product_attention, split_heads
from .flash_plain import packed_attention as flash_attention_packed
from .layers import DropoutRng, Mlp, attention_dropout_seed, checkpointed, dropout, f32_head, layer_norm
from .pair_attention import pair_self_attention

__all__ = ["Decoder", "DecoderBlock", "ClsRegBranch"]


def _single_head_attention(query, key, value, key_valid_mask, use_flash, rate, rng):
    """Single-head concat-QK cross attention, scale 1/sqrt(2C)."""
    if use_flash:
        rate, seed = attention_dropout_seed(rate, rng)
        return flash_attention_packed(query, key, value, 1, key_valid_mask, rate, seed)
    return scaled_dot_product_attention(
        query[:, None], key[:, None], value[:, None], key_valid_mask=key_valid_mask,
        dropout_rate=rate, dropout_rng=rng,
    )


class ClsRegBranch(nn.Module):
    """Single-head concat-QK cross attention + FFN (decoder.py:44-92)."""

    def __init__(self, hidden_dim: int = 256, use_flash: bool = False, dropout: float = 0.0):
        super().__init__()
        self.use_flash = use_flash
        self.dropout = dropout
        self.norm1 = layer_norm(hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim * 4)
        self.fc2 = nn.Linear(hidden_dim * 4, hidden_dim)
        self.norm2 = layer_norm(hidden_dim)

    def forward(
        self,
        inputs: torch.Tensor,  # (B, S, C)
        query: torch.Tensor,  # (B, S, 2C)
        key: torch.Tensor,  # (B, L, 2C)
        value: torch.Tensor,  # (B, L, C)
        key_valid_mask: torch.Tensor,  # (B, L)
        attn_out: Optional[torch.Tensor] = None,  # precomputed by the merged call
        rng: Optional[DropoutRng] = None,
    ) -> torch.Tensor:
        rate = self.dropout
        if attn_out is None:
            attn_out = _single_head_attention(query, key, value, key_valid_mask,
                                              self.use_flash, rate, rng)
        x = self.norm1(inputs + dropout(attn_out, rate, rng))
        h = dropout(F.relu(self.fc1(x)), rate, rng)
        x = x + dropout(self.fc2(h), rate, rng)
        return self.norm2(x)


class DecoderBlock(nn.Module):
    def __init__(self, hidden_dim: int = 256, num_heads: int = 8, lambda_pair: float = 0.5,
                 pair_mode: str = "reference", pair_output_mode: str = "reference",
                 use_flash: bool = False, dropout: float = 0.0):
        super().__init__()
        c = hidden_dim
        self.dropout = dropout
        self.hidden_dim, self.num_heads = c, num_heads
        self.lambda_pair = lambda_pair
        self.pair_mode, self.pair_output_mode = pair_mode, pair_output_mode
        self.use_flash = use_flash
        self.sa_q_obj = nn.Linear(2 * c, 2 * c, bias=False)
        self.sa_q_pos = nn.Linear(c, c, bias=False)
        self.sa_k_obj = nn.Linear(2 * c, 2 * c, bias=False)
        self.sa_k_pos = nn.Linear(c, c, bias=False)
        self.sa_v_obj = nn.Linear(2 * c, 2 * c, bias=False)
        self.norm1 = layer_norm(2 * c)
        self.norm2 = layer_norm(2 * c)
        self.ca_q_obj = nn.Linear(2 * c, 2 * c, bias=False)
        self.ca_q_pos = nn.Linear(c, c, bias=False)
        self.ca_k_enc = nn.Linear(c, c, bias=False)
        self.ca_k_pos = nn.Linear(c, c, bias=False)
        self.ca_v_enc = nn.Linear(c, c, bias=False)
        self.cls_branch = ClsRegBranch(c, use_flash, dropout)
        self.reg_branch = ClsRegBranch(c, use_flash, dropout)

    def forward(
        self,
        obj: torch.Tensor,  # (B, S, 2C)
        enc_output: torch.Tensor,  # (B, L, C)
        enc_pos: torch.Tensor,  # (B, L, C) fine positional embedding
        enc_valid_mask: torch.Tensor,  # (B, L)
        obj_coords: torch.Tensor,  # (B, S, 4) current boxes (pairing signal)
        obj_pos_embed: torch.Tensor,  # (B, S, C) static query pos embedding
        obj_sin_embed: torch.Tensor,  # (B, S, C) per-layer scaled sine embedding
        rng: Optional[DropoutRng] = None,
    ) -> torch.Tensor:
        c, h2 = self.hidden_dim, self.num_heads
        rate = self.dropout

        # --- (a) blended self attention over queries (decoder.py:120-153)
        q_pos = self.sa_q_pos(obj_pos_embed)
        k_pos = self.sa_k_pos(obj_pos_embed)
        q_m = self.sa_q_obj(obj) + torch.cat([q_pos, q_pos], dim=-1)
        k_m = self.sa_k_obj(obj) + torch.cat([k_pos, k_pos], dim=-1)
        v_m = self.sa_v_obj(obj)
        q, k, v = split_heads(q_m, h2), split_heads(k_m, h2), split_heads(v_m, h2)
        if self.use_flash:
            a_rate, seed = attention_dropout_seed(rate, rng)
            o1 = flash_attention_packed(q_m, k_m, v_m, h2, None, a_rate, seed)
        else:
            o1 = scaled_dot_product_attention(
                q, k, v, dropout_rate=rate, dropout_rng=rng
            )
        o2 = pair_self_attention(
            q, k, v, obj_coords,
            pair_mode=self.pair_mode, pair_output_mode=self.pair_output_mode,
        )
        lam = self.lambda_pair
        o = lam * self.norm1(obj + dropout(o1, rate, rng)) + (1.0 - lam) * self.norm2(
            obj + dropout(o2, rate, rng)
        )

        # --- (b) split cls/reg cross attention (decoder.py:155-196)
        o_cls, o_reg = o[..., :c], o[..., c:]
        q_obj = self.ca_q_obj(o)
        q_pos = self.ca_q_pos(obj_sin_embed)
        k_enc = self.ca_k_enc(enc_output)
        k_pos = self.ca_k_pos(enc_pos)
        v2 = self.ca_v_enc(enc_output)

        # per-head concat[content ‖ pos] (decoder_block.py:195-210)
        q_pos_h = split_heads(q_pos, h2)
        q_cls = combine_heads(torch.cat([split_heads(q_obj[..., :c], h2), q_pos_h], dim=-1))
        q_reg = combine_heads(torch.cat([split_heads(q_obj[..., c:], h2), q_pos_h], dim=-1))
        k = combine_heads(torch.cat([split_heads(k_enc, h2), split_heads(k_pos, h2)], dim=-1))

        ca_cls = ca_reg = None
        if self.use_flash:
            # one call for both branches: rows are independent and the
            # branches share K and V
            a_rate, seed = attention_dropout_seed(rate, rng)
            s = q_cls.shape[1]
            ca = flash_attention_packed(
                torch.cat([q_cls, q_reg], dim=1), k, v2, 1, enc_valid_mask, a_rate, seed
            )
            ca_cls, ca_reg = ca[:, :s], ca[:, s:]

        cls_out = self.cls_branch(o_cls, q_cls, k, v2, enc_valid_mask, attn_out=ca_cls, rng=rng)
        reg_out = self.reg_branch(o_reg, q_reg, k, v2, enc_valid_mask, attn_out=ca_reg, rng=rng)
        return torch.cat([cls_out, reg_out], dim=-1)


class Decoder(nn.Module):
    """Stack of decoder blocks with per-layer box refinement (decoder.py:199-273).
    ``bbox_embed`` is the model's shared box head, passed at call time."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 8, num_blocks: int = 6,
                 lambda_pair: float = 0.5, pair_mode: str = "reference",
                 pair_output_mode: str = "reference", use_flash: bool = False,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_blocks = num_blocks
        self.remat = remat
        self.pos_scale = Mlp(hidden_dim, [hidden_dim, hidden_dim])
        for i in range(num_blocks):
            self.add_module(
                f"block{i}",
                DecoderBlock(hidden_dim, num_heads, lambda_pair, pair_mode,
                             pair_output_mode, use_flash, dropout),
            )
        self.outer_norm = layer_norm(2 * hidden_dim)

    def forward(
        self,
        selected_objects: torch.Tensor,  # (B, S, 2C)
        encoder_output: torch.Tensor,  # (B, L, C)
        enc_valid_mask: torch.Tensor,  # (B, L)
        fine_pos: torch.Tensor,  # (B, L, C)
        obj_pos_embed: torch.Tensor,  # (B, S, C)
        selected_centers: torch.Tensor,  # (B, S, 2)
        bbox_embed: nn.Module,  # shared MLP C -> C -> 4
        rng: Optional[DropoutRng] = None,
    ) -> torch.Tensor:
        x = selected_objects
        c = self.hidden_dim
        centers_logit = inverse_sigmoid(selected_centers)
        center_embed = sine_embed_centers(selected_centers, d_model=c)
        for i in range(self.num_blocks):
            reg_half = x[..., c:]
            sin_embed = center_embed * self.pos_scale(reg_half)
            tmp_bbox = f32_head(bbox_embed, reg_half)
            obj_coords = torch.sigmoid(
                torch.cat([tmp_bbox[..., :2] + centers_logit, tmp_bbox[..., 2:]], dim=-1)
            )
            block = getattr(self, f"block{i}")
            inputs = (x, encoder_output, fine_pos, enc_valid_mask, obj_coords, obj_pos_embed, sin_embed)
            if self.remat and torch.is_grad_enabled():
                tmp = checkpointed(block, rng, *inputs)
            else:
                tmp = block(*inputs, rng)
            x = self.outer_norm(x + tmp)
        return x
