"""DESTR's auction matcher: the two hand-written CUDA kernels of
``csrc/auction.cu``, their ctypes bindings, and their plain PyTorch versions.

* The fused matching cost + auction (kernel #9): port of
  ``object_detection_destr_tpu/ops/pallas/auction.py::hungarian_match_pallas``
  (l.371) and its kernel ``_fused_kernel`` (l.271): the focal pos - neg class
  cost at each target's label plus 1 - CIoU, solved by the Bertsekas auction
  of ``_solve`` (l.71) in one launch, with a per-problem ``row_valid`` so
  problems with different real row counts (the model's top-k queries and the
  mini-detector's tokens) share the launch. As in the Pallas wrapper, the
  focal terms and the per-box atan(w / h) of the clipped cxcyhw forms are
  computed beside the kernel (:func:`fused_cost_inputs`), the rest of the
  cost inside it.
* The auction on a precomputed cost (kernel #8): port of
  ``auction.py::auction_assignment_pallas`` (l.207) and its kernel
  ``_kernel`` (l.189): the same solver on the benefit matrix
  ``where(col_valid, -cost^T, 0)`` that the wrapper builds beside it.

:func:`solve_auction` is the solver of both in plain PyTorch, with the
semantics of ``_solve`` (l.71-186). Rows are queries, columns are targets;
``value`` is the benefit matrix laid out (B, T, N) with rows that are not
real already at -1e9. Per problem:

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

A CUDA tensor launches a kernel or raises; a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...geometry.boxes import cxcyhw_to_xyxy, xyxy_to_cxcyhw
from ..focal import focal_cost_terms
from .build import CudaLibrary, LaunchCounter

__all__ = [
    "BIG",
    "AuctionAssignment",
    "FusedAuction",
    "auction_kernel",
    "fused_auction",
    "fused_auction_operands",
    "fused_cost_inputs",
    "hungarian_match_fused",
    "hungarian_match_fused_reference",
    "matching_value_reference",
    "precomputed_value",
    "solve_auction",
    "solver_smem_bytes",
    "value_rows_in_smem",
]

BIG = 1e9

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary(
    "odtt_auction", "auction.cu",
    functions={"odtt_fused_auction": (_I, [_P] * 12 + [_I] * 4 + [_F] * 3 + [_I, _I, _P]),
               "odtt_auction": (_I, [_P] * 6 + [_I] * 3 + [_F, _I, _I, _P])},
    abi=("odtt_auction_abi_version", 4),
    flags=("-fmad=false",),
)
# shared memory a block of either kernel gives to the value rows of its valid
# columns (csrc/auction.cu); a problem with more valid columns than fit
# keeps them in global memory
_VALUE_SMEM_BYTES = 96 * 1024
# the dynamic shared memory a block may take on sm_90 (227 KB), less 1 KB for
# the kernels' static Counts
_BLOCK_SMEM_BYTES = 227 * 1024 - 1024


def solver_smem_bytes(n: int, t: int, rows_smem: int) -> int:
    """A block's dynamic shared memory, as csrc/auction.cu's Solver::bytes
    counts it: per row a bid key, price, owner, free-list entry and real
    flag; per column three ints; ``rows_smem`` value rows of N floats."""
    return n * (8 + 3 * 4 + 1) + t * 3 * 4 + rows_smem * n * 4


def value_rows_in_smem(n: int, t: int) -> int:
    """Valid columns whose (N,) value rows a block keeps in shared memory:
    61 at N = 400, so the training step's problems (at most 8 valid targets)
    never touch global memory for them; at the dilated C5's N = 7056 the
    solver's own state leaves room for 2."""
    room = (_BLOCK_SMEM_BYTES - solver_smem_bytes(n, t, 0)) // (4 * n)
    if room < 0:
        raise ValueError(f"auction: N={n} rows and T={t} columns need {solver_smem_bytes(n, t, 0)} bytes of "
                         f"shared memory a block, more than the {_BLOCK_SMEM_BYTES} it may take")
    return min(t, _VALUE_SMEM_BYTES // (4 * n), room)


def solve_auction(
    value: torch.Tensor,
    col_valid: torch.Tensor,
    row_valid: torch.Tensor,
    eps_frac: float = 0.001,
    max_iters: int = 256,
    bids_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Args:
        value: (B, T, N) float32 benefits, -1e9 on rows that are not real.
        col_valid: (B, T) bool; row_valid: (B, N) bool.
        bids_out: optional (B,) integer tensor; the bids of every round
            (one a bidding column) are added to it, as the kernels count them.

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
        if bids_out is not None:
            bids_out += bidding.sum(1).to(bids_out.dtype)
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



def fused_cost_inputs(pred_logits, pred_boxes, tgt_boxes, eps: float = 1e-6):
    """The terms computed beside the kernel (auction.py:407-422):
    pn (B, C, N) = focal pos - neg per class, atan(w/h) of the predictions'
    clipped cxcyhw form (B, N) and of the targets' (B, T)."""
    pos, neg = focal_cost_terms(torch.sigmoid(pred_logits.float()))
    pn = (pos - neg).transpose(1, 2).contiguous()
    pc = xyxy_to_cxcyhw(cxcyhw_to_xyxy(pred_boxes.float()))
    atan_p = torch.atan(pc[..., 3] / torch.clamp(pc[..., 2], min=eps))
    gc = xyxy_to_cxcyhw(tgt_boxes.float())
    atan_g = torch.atan(gc[..., 3] / torch.clamp(gc[..., 2], min=eps))
    return pn, atan_p.contiguous(), atan_g.contiguous()


def matching_value_reference(pn, pred_boxes, atan_p, tgt_boxes, atan_g, labels, col_valid,
                             row_valid, cost_class: float = 1.0, cost_ciou: float = 1.0,
                             epsilon: float = 1e-6) -> torch.Tensor:
    """The kernel's (B, T, N) value matrix, operation for operation
    (auction.py:306-360): -cost on valid columns, 0 on invalid ones, -1e9 on
    rows that are not real."""
    b, c, n = pn.shape
    in_range = (labels >= 0) & (labels < c)
    lab = labels.clamp(0, c - 1).long()
    c_class = torch.where(in_range[..., None], pn.gather(1, lab[..., None].expand(b, lab.shape[1], n)), 0.0)

    p = pred_boxes.float()[:, None, :, :]  # (B, 1, N, 4)
    cx, cy, h, w = p.unbind(-1)
    px1 = torch.clamp(cx - w / 2, min=0.0)
    py1 = torch.clamp(cy - h / 2, min=0.0)
    px2 = torch.clamp(cx + w / 2, max=1.0)
    py2 = torch.clamp(cy + h / 2, max=1.0)
    tx1, ty1, tx2, ty2 = tgt_boxes.float()[:, :, None, :].unbind(-1)  # (B, T, 1)
    iw = torch.clamp(torch.minimum(px2, tx2) - torch.maximum(px1, tx1), min=0.0)
    ih = torch.clamp(torch.minimum(py2, ty2) - torch.maximum(py1, ty1), min=0.0)
    inter = iw * ih
    parea = (px2 - px1) * (py2 - py1)
    tarea = (tx2 - tx1) * (ty2 - ty1)
    iou = inter / torch.clamp(parea + tarea - inter, min=epsilon)
    ew = torch.clamp(torch.maximum(px2, tx2) - torch.minimum(px1, tx1), min=0.0)
    eh = torch.clamp(torch.maximum(py2, ty2) - torch.minimum(py1, ty1), min=0.0)
    diag_sq = ew * ew + eh * eh
    dx = torch.clamp((px1 + px2) / 2, 0.0, 1.0) - torch.clamp((tx1 + tx2) / 2, 0.0, 1.0)
    dy = torch.clamp((py1 + py2) / 2, 0.0, 1.0) - torch.clamp((ty1 + ty2) / 2, 0.0, 1.0)
    center_sq = dx * dx + dy * dy
    da = atan_g[:, :, None] - atan_p[:, None, :]
    v = (4.0 / math.pi**2) * (da * da)
    alpha = torch.where(iou > 0.5, v / (1.0 - iou + v), 0.0)
    cious = torch.clamp(iou - center_sq / torch.clamp(diag_sq, min=epsilon) - alpha * v, -1.0, 1.0)
    cost = cost_class * c_class + cost_ciou * (1.0 - cious)
    value = torch.where(col_valid[:, :, None], -cost, 0.0)
    return torch.where(row_valid[:, None, :], value, -BIG)


def _row_valid(pred_logits, row_valid):
    if row_valid is None:
        return torch.ones(pred_logits.shape[:2], dtype=torch.bool, device=pred_logits.device)
    return row_valid


def hungarian_match_fused_reference(pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid,
                                    row_valid=None, cost_class: float = 1.0,
                                    cost_ciou: float = 1.0, eps_frac: float = 0.001,
                                    max_iters: int = 256, bids_out: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch: (rows (B, T) int64, rounds (B,));
    ``bids_out`` as :func:`solve_auction` takes it."""
    row_valid = _row_valid(pred_logits, row_valid)
    pn, atan_p, atan_g = fused_cost_inputs(pred_logits, pred_boxes, tgt_boxes)
    value = matching_value_reference(pn, pred_boxes, atan_p, tgt_boxes, atan_g, tgt_labels,
                                     col_valid, row_valid, cost_class, cost_ciou)
    return solve_auction(value, col_valid, row_valid, eps_frac, max_iters, bids_out)


def fused_auction_operands(pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid, row_valid):
    """The operands of #9's launch, computed beside it, all contiguous: pn
    (B, C, N), boxes (B, N, 4), atan_p (B, N), targets (B, T, 4) and atan_g
    (B, T) float32 (:func:`fused_cost_inputs`), labels (B, T) int32,
    col_valid (B, T) and row_valid (B, N) bool."""
    pn, atan_p, atan_g = fused_cost_inputs(pred_logits, pred_boxes, tgt_boxes)
    return (pn, pred_boxes.float().contiguous(), atan_p, tgt_boxes.float().contiguous(), atan_g,
            tgt_labels.to(torch.int32).contiguous(), col_valid.contiguous(), row_valid.contiguous())


class FusedAuction(LaunchCounter):
    """The kernel's wrapper: computes the terms beside it, checks the
    operands, allocates outputs (and the scratch for valid columns beyond
    :func:`value_rows_in_smem`) and launches one block per problem on the
    current stream. ``launches`` counts kernel launches and
    nothing else; ``last_rounds`` and ``last_bids`` hold the (B,) bidding
    rounds and the bids made over them in the last launch (read them only
    after a synchronize)."""

    library = LIBRARY

    def __init__(self):
        super().__init__()
        self.last_rounds: Optional[torch.Tensor] = None
        self.last_bids: Optional[torch.Tensor] = None

    def __call__(self, pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid, row_valid=None,
                 cost_class: float = 1.0, cost_ciou: float = 1.0, eps_frac: float = 0.001,
                 max_iters: int = 256):
        """Returns (rows (B, T) int64, rounds (B,) int32)."""
        row_valid = _row_valid(pred_logits, row_valid)
        tensors = (pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid, row_valid)
        if not all(t.is_cuda and t.device == pred_logits.device for t in tensors):
            raise ValueError("fused_auction: every operand must be on one CUDA device")
        b, n, c = pred_logits.shape
        t = tgt_boxes.shape[1]
        if pred_boxes.shape != (b, n, 4) or tgt_boxes.shape != (b, t, 4) \
                or tgt_labels.shape != (b, t) or col_valid.shape != (b, t) or row_valid.shape != (b, n):
            raise ValueError("fused_auction: shape mismatch")
        if col_valid.dtype != torch.bool or row_valid.dtype != torch.bool:
            raise TypeError("col_valid and row_valid must be bool")
        if t > n or t == 0:
            raise ValueError(f"fused_auction needs 0 < T <= N, got T={t}, N={n}")
        operands = fused_auction_operands(pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid, row_valid)
        rows, rounds = self.launch(operands, cost_class, cost_ciou, eps_frac, max_iters)
        return rows.long(), rounds

    def launch(self, operands, cost_class: float = 1.0, cost_ciou: float = 1.0, eps_frac: float = 0.001,
               max_iters: int = 256):
        """The launch alone, on :func:`fused_auction_operands`. Returns
        (rows (B, T) int32, rounds (B,) int32)."""
        pn, boxes, atan_p, targets, atan_g, labels, colv, rowv = operands
        b, c, n = pn.shape
        t = targets.shape[1]
        dev = pn.device
        rows_smem = value_rows_in_smem(n, t)
        # only the valid columns' rows are built, and in global memory only
        # where they do not fit the block's shared memory
        value = torch.empty((b, t, n), dtype=torch.float32, device=dev) if rows_smem < t else None
        rows = torch.empty((b, t), dtype=torch.int32, device=dev)
        rounds = torch.empty((b,), dtype=torch.int32, device=dev)
        bids = torch.empty((b,), dtype=torch.int32, device=dev)
        lib = self.library.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.odtt_fused_auction(
                pn.data_ptr(), boxes.data_ptr(), atan_p.data_ptr(), targets.data_ptr(),
                atan_g.data_ptr(), labels.data_ptr(), colv.data_ptr(), rowv.data_ptr(),
                None if value is None else value.data_ptr(), rows.data_ptr(), rounds.data_ptr(),
                bids.data_ptr(), b, n, t, c, float(cost_class), float(cost_ciou), float(eps_frac),
                int(max_iters), rows_smem, stream,
            )
        if err != 0:
            raise RuntimeError(f"fused_auction launch failed: CUDA error {err}")
        self.count_launch(stream)
        self.last_rounds, self.last_bids = rounds, bids
        return rows, rounds


fused_auction = FusedAuction()


def hungarian_match_fused(pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid,
                          row_valid=None, cost_class: float = 1.0, cost_ciou: float = 1.0,
                          eps_frac: float = 0.001, max_iters: int = 256) -> torch.Tensor:
    """(B, T) int64 query row per target, duplicate-free: the kernel for
    CUDA tensors, its plain version for CPU tensors. No gradient flows."""
    with torch.no_grad():
        fn = fused_auction if pred_logits.is_cuda else hungarian_match_fused_reference
        return fn(pred_logits, pred_boxes, tgt_boxes, tgt_labels, col_valid, row_valid,
                  cost_class, cost_ciou, eps_frac, max_iters)[0]


def precomputed_value(cost: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    """The benefit matrix of a precomputed (B, N, T) cost, (B, T, N) float32:
    -cost^T on valid columns, 0 on invalid ones, as the Pallas wrapper
    builds it in XLA (auction.py:232)."""
    return torch.where(col_valid[:, :, None], -cost.float().transpose(1, 2), 0.0).contiguous()


class AuctionAssignment(LaunchCounter):
    """Kernel #8's wrapper: the solver of ``csrc/auction.cu`` on a given
    (B, T, N) value matrix (:func:`precomputed_value`: an invalid column
    holds 0 on real rows and -1e9 on the others, which the kernel assumes
    and does not read), one block per problem, on the current stream. ``launches`` counts kernel launches and
    nothing else; ``last_rounds`` and ``last_bids`` hold the (B,) bidding
    rounds and the bids made over them in the last launch (read them only
    after a synchronize)."""

    library = LIBRARY

    def __init__(self):
        super().__init__()
        self.last_rounds: Optional[torch.Tensor] = None
        self.last_bids: Optional[torch.Tensor] = None

    def __call__(self, value, col_valid, row_valid, eps_frac: float = 0.001, max_iters: int = 256):
        """The arguments of :func:`solve_auction`; returns (rows (B, T)
        int64, rounds (B,) int32)."""
        if not all(x.is_cuda and x.device == value.device for x in (value, col_valid, row_valid)):
            raise ValueError("auction_kernel: every operand must be on one CUDA device")
        b, t, n = value.shape
        if value.dtype != torch.float32 or col_valid.shape != (b, t) or row_valid.shape != (b, n):
            raise ValueError("auction_kernel takes a (B, T, N) float32 value, (B, T) and (B, N) masks")
        if col_valid.dtype != torch.bool or row_valid.dtype != torch.bool:
            raise TypeError("col_valid and row_valid must be bool")
        if t > n or t == 0:
            raise ValueError(f"auction_kernel needs 0 < T <= N, got T={t}, N={n}")
        value, colv, rowv = value.contiguous(), col_valid.contiguous(), row_valid.contiguous()
        dev = value.device
        rows = torch.empty((b, t), dtype=torch.int32, device=dev)
        rounds = torch.empty((b,), dtype=torch.int32, device=dev)
        bids = torch.empty((b,), dtype=torch.int32, device=dev)
        lib = self.library.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.odtt_auction(value.data_ptr(), colv.data_ptr(), rowv.data_ptr(), rows.data_ptr(),
                                   rounds.data_ptr(), bids.data_ptr(), b, n, t, float(eps_frac),
                                   int(max_iters), value_rows_in_smem(n, t), stream)
        if err != 0:
            raise RuntimeError(f"auction_kernel launch failed: CUDA error {err}")
        self.count_launch(stream)
        self.last_rounds, self.last_bids = rounds, bids
        return rows.long(), rounds


auction_kernel = AuctionAssignment()
