"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/ops/attention.py`` l.1-91, its kernels replaced by their plain versions and its data-parallel paths left out.]

Attention primitives (port of ``object_detection_destr_tpu/ops/attention.py``).

Batch-first ``(B, S, D)`` or pre-split ``(B, h, S, d)``. Logits and the
softmax are float32; masked keys are set to -1e9, not -inf, so a row whose
keys are all masked gets uniform weights instead of NaN (attention.py:31, :88).
This is the plain path the model takes with ``use_flash_attention=False``;
its probability dropout (attention.py:90-92) draws its keep mask from an
explicit stream (the model's ``DropoutRng``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


def _autocast(device_type: str, **kwargs):
    """``torch.autocast``, and nothing on the meta device."""
    return contextlib.nullcontext() if device_type == "meta" else torch.autocast(device_type, **kwargs)


__all__ = ["NEG_INF", "scaled_dot_product_attention", "multi_head_attention", "split_heads", "combine_heads"]

NEG_INF = -1e9  # finite -inf stand-in: keeps softmax well-defined on full-pad rows


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, D) -> (B, h, S, D/h)."""
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def combine_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, h, S, d) -> (B, S, h*d)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def scaled_dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    key_valid_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_rng=None,
) -> torch.Tensor:
    """Attention over pre-split heads.

    Args:
        query/key: (B, h, S_q, d) / (B, h, S_k, d).
        value: (B, h, S_k, d_v) — d_v may differ from d.
        key_valid_mask: (B, S_k) bool, True = attendable.
        scale: default 1/sqrt(d).
        dropout_rate, dropout_rng: probability dropout (keep with
            probability 1 - rate, kept values scaled by 1 / (1 - rate)) when
            a stream is given, its mask from ``dropout_rng.keep_mask(shape,
            rate, device)``; none without one.

    Returns:
        (B, S_q, h*d_v) — heads merged, batch-first, in the value dtype.
    """
    d = query.shape[-1]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    with _autocast(query.device.type, enabled=False):
        logits = torch.matmul(query.float(), key.float().transpose(-1, -2)) * scale
        if key_valid_mask is not None:
            logits = logits.masked_fill(~key_valid_mask[:, None, None, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        if dropout_rate > 0.0 and dropout_rng is not None:
            keep = dropout_rng.keep_mask(probs.shape, dropout_rate, probs.device)
            probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
        # P is rounded to the value dtype before P V, as attention.py:94 does
        out = torch.matmul(probs.to(value.dtype).float(), value.float()).to(value.dtype)
    return combine_heads(out)


def multi_head_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_heads: int,
    *,
    key_valid_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_rng=None,
) -> torch.Tensor:
    """Projection-free MHA over (B, S, D) tensors (attention.py:100-121): the
    heads split off, :func:`scaled_dot_product_attention`, merged back to
    (B, S_q, D_v). The projections live in the calling module."""
    return scaled_dot_product_attention(
        split_heads(query, num_heads), split_heads(key, num_heads), split_heads(value, num_heads),
        key_valid_mask=key_valid_mask, dropout_rate=dropout_rate, dropout_rng=dropout_rng,
    )
