"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/ops/topk.py`` l.1-49, its kernels replaced by their plain versions and its data-parallel paths left out.]

Masked top-k with index recycling (port of
``object_detection_destr_tpu/ops/topk.py``).

Ties order as ``lax.top_k`` orders them, lowest index first: ``torch.topk``
does not promise that, so the ranking is a stable descending sort.
"""

from __future__ import annotations

import torch

__all__ = ["masked_topk_with_recycle", "stable_topk"]


def stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, equal scores ordered by ascending index."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def masked_topk_with_recycle(
    scores: torch.Tensor, k: int, valid_mask: torch.Tensor
) -> torch.Tensor:
    """Top-k indices per row, recycling valid indices when valid < k
    (topk.py:32-64).

    Args:
        scores: (B, S) non-negative scores.
        k: number of indices to return (k <= S).
        valid_mask: (B, S) bool, True = valid token.

    Returns:
        (B, k) int64 indices into S.
    """
    b, s = scores.shape
    if k > s:
        raise ValueError(f"k={k} must be <= sequence length {s}")
    scores = torch.where(valid_mask, scores, torch.zeros_like(scores))
    # ranks valid above invalid even for a valid score of exactly 0 (the
    # 1e-12 vanishes in float32 for scores near 0.5, as it does in JAX)
    scores = scores + valid_mask.to(scores.dtype) * 1e-12
    _, topk_idx = stable_topk(scores, k)

    valid_counts = valid_mask.sum(dim=-1).clamp(min=1)  # guard all-pad rows
    pos = torch.arange(k, device=scores.device)[None, :]
    v = torch.clamp(valid_counts, max=k)[:, None]
    # i < v: take slot i; i >= v: take slot v - 1 - (i mod v) (flip-tile recycle)
    slot = torch.where(pos < v, pos, v - 1 - (pos % v))
    return torch.gather(topk_idx, 1, slot)
