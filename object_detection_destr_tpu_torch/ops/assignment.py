"""Min-cost assignment of target columns to query rows on a precomputed
cost: port of ``object_detection_destr_tpu/ops/assignment.py``
(``auction_assignment`` l.152, ``batched_assignment`` l.163).

On CUDA tensors :func:`batched_assignment` launches kernel #8 (the auction of
``csrc/auction.cu`` on a given value matrix, as the JAX package dispatches to
``auction_assignment_pallas`` on the TPU); on CPU tensors it runs that
kernel's plain version, ``ops/cuda/auction.py::solve_auction``. Both take the
benefit matrix ``where(col_valid, -cost^T, 0)`` with every row real.
"""

from __future__ import annotations

import torch

from .cuda.auction import BIG, auction_kernel, precomputed_value, solve_auction

__all__ = ["BIG", "auction_assignment", "batched_assignment", "solve_auction"]


def batched_assignment(
    cost: torch.Tensor,
    col_valid: torch.Tensor,
    eps_frac: float = 0.001,
    max_iters: int = 256,
) -> torch.Tensor:
    """Batched min-cost assignment.

    Args:
        cost: (B, N, M) cost matrices, N >= M (rows = queries, cols = targets).
        col_valid: (B, M) bool, True for real targets.

    Returns:
        (B, M) int64: ``rows[b, j]`` is the query assigned to target j
        (duplicate-free; meaningful only where ``col_valid``).
    """
    value = precomputed_value(cost, col_valid)
    row_valid = torch.ones(cost.shape[:2], dtype=torch.bool, device=cost.device)
    solver = auction_kernel if cost.is_cuda else solve_auction
    return solver(value, col_valid, row_valid, eps_frac, max_iters)[0]


def auction_assignment(
    cost: torch.Tensor,
    col_valid: torch.Tensor,
    eps_frac: float = 0.001,
    max_iters: int = 256,
) -> torch.Tensor:
    """Single-problem wrapper of :func:`batched_assignment`: cost (N, M),
    col_valid (M,); returns (M,) int64 rows."""
    return batched_assignment(cost[None], col_valid[None], eps_frac, max_iters)[0]
