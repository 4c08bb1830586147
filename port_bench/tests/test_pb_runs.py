"""Whole runs of each generator at a tiny size on the CPU, the look for a
card skipped (``cli.run_cell``): sound runs come out correct with the real
cells' limits; with the timed path broken underneath, correct comes out
false, once for each fault the cell can have. One chip, so there is no
exchange between chips to leave out; a training cell produces no answer to
alter."""

import json

import pytest
import torch

from port_bench.harness import cli, compare
from port_bench.tests import choices
from port_bench.tests.calibrate import control_numbers
from port_bench.tests.faults import planted
from port_bench.tests.tiny import run_tiny, tiny_cell, tiny_ctx


@pytest.mark.parametrize("cell", ["train-coco-800"])
def test_a_sound_run_is_correct(cell, tmp_path):
    code, line = cli.run_cell(tiny_ctx(cell, tmp_path))
    assert code == 0 and line["correct"], line
    assert list(line)[-1] == "checks" and json.loads(json.dumps(line)) == line
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("cell, fault", [("train-coco-800", "unchanged"), ("train-coco-800", "half")])
def test_a_fault_is_not_correct(cell, fault, tmp_path):
    with planted(fault):
        code, line = cli.run_cell(tiny_ctx(cell, tmp_path))
    assert code == 0 and not line["correct"], (fault, line["checks"])


def test_the_int8_control_fails_the_training_numbers(tmp_path):
    """The control of a bfloat16 cell (the reference with int8 operands and
    gradients) against the reference, at the tiny size; the card reads it at
    the cell's own size (``calibrate.py --control``)."""
    ctx = tiny_ctx("train-coco-800", tmp_path)
    run, checks = run_tiny("train-coco-800", tmp_path)
    numbers = control_numbers(ctx, run, "int8")
    assert any(numbers[k] > limit for k, (_, limit) in checks.items()), numbers


def test_the_choices_counted_and_replayed_at_a_tiny_size():
    """``choices.py`` on the CPU in float32: the program and the reference
    choose alike at every step, and the reference that takes the program's
    choices (all of them, or it raises) reads as the reference does."""
    row = choices.one_seed(tiny_cell("train-coco-800"), 2**31 + 99)
    assert len(row["differ"]) == 3 and all(d["targets"] > 0 and d["topk_of"] > 0 for d in row["differ"])
    assert all(d["topk"] == d["pairs"] == d["match_model"] == d["match_det"] == 0 for d in row["differ"])
    assert row["replayed"] == row["as_is"]
    a = {"topk": [torch.tensor([[1, 2, 3]])], "pairs": [torch.tensor([[[0, 1], [1, 0], [2, 1]]])],
         "match": [(torch.tensor([[0, 2]]), torch.tensor([[1, 1]]), torch.tensor([[True, False]]))]}
    b = {"topk": [torch.tensor([[3, 2, 4]])], "pairs": [torch.tensor([[[0, 1], [1, 2], [2, 1]]])],
         "match": [(torch.tensor([[1, 0]]), torch.tensor([[1, 0]]), torch.tensor([[True, False]]))]}
    assert choices.differ(a, b) == {"topk": 1, "topk_of": 3, "pairs": 1, "pairs_of": 3, "match_model": 1,
                                    "match_det": 0, "targets": 1}


def test_the_comparisons_on_made_up_answers():
    losses = {"loss": [1.0, 2.0], "loss_model": [1.0, 2.0], "loss_det": [1.0, 2.0]}
    prog = {**losses, "grad": {"a": 1.0, "b": 2.0, "c": 1e-9}, "change": {"a": 0.0, "b": 1.0, "c": 5.0}}
    ref_t = {**losses, "loss": [1.0, 2.2], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9},
             "change": {"a": 1.0, "b": 1.0, "c": 0.0}}
    numbers = compare.train_numbers(prog, ref_t)
    assert numbers["loss_gap"] == pytest.approx(0.2 / 2.2) and numbers["grad_gap"] == 0.0
    assert numbers["change_gap"] == 1.0  # "a" unmoved; "c" moves by round-off alone and is left out
    assert numbers["change_gap_median"] == 0.5 and numbers["loss_det_gap"] == 0.0
