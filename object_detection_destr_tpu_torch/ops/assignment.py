"""Batched Bertsekas forward auction in plain PyTorch, with the semantics of
the TPU kernels' shared solver ``object_detection_destr_tpu/ops/pallas/
auction.py::_solve`` (l.71-186).

Rows are queries, columns are targets; ``value`` is the benefit matrix laid
out (B, T, N) with rows that are not real already at -1e9. Per problem:

* eps = eps_frac * max(vmax - vmin, 1e-6) over real rows and valid columns,
  with 0 folded in when an invalid column exists (l.85-97);
* each round every unassigned valid column bids for its best row (lowest
  index on ties) by ``best - max(second, best - range - 1) + eps``
  (l.105-113); a row takes the highest bid, lowest column on ties, and its
  owner is evicted (l.115-146); rounds repeat while a valid column is
  unassigned, at most ``max_iters``;
* greedy completion then gives every column still without a row, in column
  order, the first free row of highest value (l.157-185), so the result is
  duplicate-free everywhere.

``ops/cuda/auction.py`` builds the fused kernel's value matrix and runs this
solver as the kernel's plain version. :func:`auction_assignment` is the
function of the precomputed-cost kernel ``auction.py::_kernel`` (l.189),
which is not ported yet: it runs here on CPU tensors only.
"""

from __future__ import annotations

import torch

__all__ = ["BIG", "solve_auction", "auction_assignment"]

BIG = 1e9


def solve_auction(
    value: torch.Tensor,
    col_valid: torch.Tensor,
    row_valid: torch.Tensor,
    eps_frac: float = 0.001,
    max_iters: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Args:
        value: (B, T, N) float32 benefits, -1e9 on rows that are not real.
        col_valid: (B, T) bool; row_valid: (B, N) bool.

    Returns:
        rows (B, T) int64, duplicate-free; rounds (B,) int64, the bidding
        rounds each problem ran.
    """
    b, t, n = value.shape
    dev = value.device
    value = value.float()
    real = row_valid[:, None, :] & col_valid[:, :, None]
    has_inv = (~col_valid).any(1)
    vmax = torch.where(real, value, -BIG).amax((1, 2))
    vmin = torch.where(real, value, BIG).amin((1, 2))
    vmax = torch.maximum(vmax, torch.where(has_inv, 0.0, -BIG))
    vmin = torch.minimum(vmin, torch.where(has_inv, 0.0, BIG))
    value_range = torch.clamp(vmax - vmin, min=1e-6)[:, None]  # (B, 1)
    eps = eps_frac * value_range

    prices = torch.zeros((b, n), dtype=torch.float32, device=dev)
    owner = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    roc = torch.full((b, t), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros(b, dtype=torch.int64, device=dev)
    cols = torch.arange(t, device=dev).expand(b, t)
    for _ in range(max_iters):
        bidding = (roc < 0) & col_valid
        active = bidding.any(1)
        if not bool(active.any()):
            break
        rounds += active
        net = value - prices[:, None, :]
        best_v, best_i = net.max(-1)  # first index of the maximum
        second_v = net.scatter(-1, best_i[..., None], -BIG).amax(-1)
        second_v = torch.maximum(second_v, best_v - value_range - 1.0)
        bid = best_v - second_v + eps
        bid_price = torch.where(bidding, prices.gather(1, best_i) + bid, -BIG)
        row_bids = torch.full((b, n), -BIG, device=dev).scatter_reduce(
            1, best_i, bid_price, "amax", include_self=True
        )
        got = row_bids > -BIG / 2
        top = bidding & (bid_price == row_bids.gather(1, best_i))
        win_col = torch.full((b, n), t, dtype=torch.int64, device=dev).scatter_reduce(
            1, best_i, torch.where(top, cols, t), "amin", include_self=True
        )
        bi, ni = (got & (owner >= 0)).nonzero(as_tuple=True)
        roc[bi, owner[bi, ni]] = -1  # evict the owners of rows that got bids
        bi, ni = got.nonzero(as_tuple=True)
        roc[bi, win_col[bi, ni]] = ni
        owner = torch.where(got, win_col, owner)
        prices = torch.where(got, row_bids, prices)

    free = torch.ones((b, n), dtype=torch.bool, device=dev)
    bi, ti = (roc >= 0).nonzero(as_tuple=True)
    free[bi, roc[bi, ti]] = False
    batch = torch.arange(b, device=dev)
    for j in (roc < 0).any(0).nonzero().flatten().tolist():
        cur = roc[:, j]
        needs = cur < 0
        pick = torch.where(free, value[:, j, :], -BIG).argmax(-1)
        roc[:, j] = torch.where(needs, pick, cur)
        free[batch[needs], pick[needs]] = False
    return roc, rounds


def auction_assignment(
    cost: torch.Tensor,
    col_valid: torch.Tensor,
    eps_frac: float = 0.001,
    max_iters: int = 256,
) -> torch.Tensor:
    """Min-cost assignment on a precomputed (B, N, T) cost, N >= T: the
    function of ``auction.py::auction_assignment_pallas`` (benefit -cost,
    invalid columns zeroed). Returns (B, T) int64 rows."""
    if cost.is_cuda:
        raise NotImplementedError(
            "the precomputed-cost auction kernel (auction.py::_kernel) is not ported to CUDA yet"
        )
    value = torch.where(col_valid[:, :, None], -cost.float().transpose(1, 2), 0.0)
    row_valid = torch.ones(cost.shape[:2], dtype=torch.bool, device=cost.device)
    return solve_auction(value, col_valid, row_valid, eps_frac, max_iters)[0]
