"""The numbers that decide ``correct``: the program's outputs against the
reference's.

Training (the first steps of the window's own call):
  ``loss_gap``, ``loss_model_gap``, ``loss_det_gap``: the largest relative
  gap of a step's loss, of its model part and of its mini-detector part;
  ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it (its first moment after one step over
  ``1 - b1``), over the larger of the reference's norm of that leaf and of
  the median leaf; ``grad_gap_median``: the median leaf's;
  ``change_gap``, ``change_gap_median``: the same of each leaf's change
  after the checked steps. Leaves whose reference gradient is under a
  thousandth of the median leaf's move by round-off alone and are left out
  of the leaf numbers. A cell compares those its ``limits`` name."""

from __future__ import annotations

import statistics

import numpy as np

__all__ = ["NUMBERS", "train_numbers", "worst_leaves", "ROUND_OFF"]

ROUND_OFF = 1e-3


def _leaf_gaps(program: dict, reference: dict, keep) -> list[float]:
    median = statistics.median(reference[k] for k in keep)
    return [abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in keep]


def _relative(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def train_numbers(program: dict, reference: dict) -> dict[str, float]:
    """program / reference: {"loss", "loss_model", "loss_det": [each
    step's], "grad": {leaf: norm}, "change": {leaf: norm}}; the program's
    leaves with moments must be the reference's."""
    inf = float("inf")
    keys = ("loss", "loss_model", "loss_det")
    if any(len(program[k]) != len(reference[k]) for k in keys) or set(program["grad"]) != set(reference["grad"]):
        return dict.fromkeys(NUMBERS, inf)
    if not all(np.isfinite(program[k]).all() for k in keys):
        return dict.fromkeys(NUMBERS, inf)
    median_grad = statistics.median(reference["grad"].values())
    moved = [k for k, g in reference["grad"].items() if g >= ROUND_OFF * median_grad]
    grad = _leaf_gaps(program["grad"], reference["grad"], moved)
    change = _leaf_gaps(program["change"], reference["change"], moved)
    out = {f"{k}_gap": max(_relative(a, b) for a, b in zip(program[k], reference[k])) for k in keys}
    out.update(grad_gap=max(grad), grad_gap_median=float(statistics.median(grad)), change_gap=max(change),
               change_gap_median=float(statistics.median(change)))
    return out


NUMBERS = ("loss_gap", "loss_model_gap", "loss_det_gap", "grad_gap", "grad_gap_median", "change_gap",
           "change_gap_median")


def worst_leaves(program: dict, reference: dict, key: str, top: int = 5) -> list[tuple[str, float, float, float]]:
    """The ``top`` leaves of the largest gap of ``key`` ("grad" or
    "change"): (leaf, gap, program's norm, reference's norm)."""
    median = statistics.median(reference["grad"].values())
    moved = [k for k, g in reference["grad"].items() if g >= ROUND_OFF * median]
    scale = statistics.median(reference[key][k] for k in moved)
    rows = [(k, abs(program[key][k] - reference[key][k]) / max(reference[key][k], scale, 1e-30),
             program[key][k], reference[key][k]) for k in moved]
    return sorted(rows, key=lambda r: -r[1])[:top]

