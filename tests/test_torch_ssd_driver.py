"""The port's SSD trainer end to end on the CPU, at the smallest set that gives
one batch (one 300 px image a split, B=1; the JAX driver's own end-to-end
SSD test is marked slow):

* ``train_ssd.main`` for 2 epochs with the EMA, validating and saving at the
  second (``--val_interval 2 --save_interval 2``, to keep the CPU work and
  the checkpoint writes few): per-step losses and the validation sweep
  (``Loss/valid/*``, ``Metric/mAP``, the EMA sweep) are logged, the
  ``ssd``, ``ssd_ema`` and ``ssd_last`` checkpoints written;
* ``infer.evaluate.main --model ssd`` on the best checkpoint reproduces the
  driver's mAP and validation loss (1e-6);
* a run of 1 epoch resumed from its ``_last`` for 1 more ends bit-equal to
  the 2-epoch run, its step count going on from 1;
* ``--device_cache --epoch_scan`` (the epoch runner's body, uncaptured on
  the CPU) ends its epoch bit-equal to the per-step run's; ``--epoch_scan``
  without the cache is ignored with a notice.
"""

import json
import os

import pytest
import torch

from object_detection_destr_tpu_torch.infer import evaluate
from object_detection_destr_tpu_torch.train import train_ssd

FLAGS = ["--device", "cpu", "--batch_size", "1", "--num_train_samples", "1", "--num_valid_samples", "1",
         "--augment_factor", "1", "--synthetic_size", "96", "--compute_dtype", "float32", "--log_interval", "1",
         "--hard_neg_mining", "paper", "--lr", "1e-4"]


def _run(tmp, name, epochs, *extra):
    flags = FLAGS + ["--epochs", str(epochs), "--checkpoint_dir", str(tmp / "ckpt"), "--log_dir", str(tmp / name),
                     *extra]
    return train_ssd.main(flags)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ssd")
    whole = _run(tmp, "whole", 2, "--ema_decay", "0.9", "--val_interval", "2", "--save_interval", "2",
                 "--save_as", "ssd")
    files = sorted(os.listdir(tmp / "ckpt"))
    evaluated = evaluate.main(["--model", "ssd"] + FLAGS + ["--checkpoint_dir", str(tmp / "ckpt"),
                                                            "--resume_from", "ssd"])
    first = _run(tmp, "first", 1, "--save_as", "part")
    resumed = _run(tmp, "resumed", 1, "--save_as", "part", "--resume", "--resume_from", "part_last")
    return tmp, whole, files, evaluated, first, resumed


def test_train_ssd_logs_validates_and_checkpoints(runs):
    tmp, whole, files, *_ = runs
    assert files == ["ssd", "ssd_ema", "ssd_last"]
    assert whole["state"].step == 2 and [h["epoch"] for h in whole["history"]] == [1]
    records = [json.loads(line) for line in open(tmp / "whole" / "metrics.jsonl")]
    tags = {r.get("tag") for r in records}
    assert {"Loss/valid/loss", "Loss/valid/class", "Loss/valid/local", "Metric/mAP", "Loss/valid_ema/loss",
            "Metric/ema_mAP"} <= tags
    train = [r for r in records if r.get("prefix") == "train"]
    assert [r["step"] for r in train] == [1, 2] and all(r["loss"] > 0 for r in train)
    assert whole["best_val"] == min(h["valid"]["loss"] for h in whole["history"])


def test_evaluate_ssd_reproduces_the_drivers_sweep(runs):
    _, whole, _, evaluated, *_ = runs
    saved = [h for h in whole["history"] if h["valid"]["loss"] == whole["best_val"]][0]
    assert abs(evaluated["map"] - saved["mAP"]) <= 1e-6
    assert abs(evaluated["val_loss"] - saved["valid"]["loss"]) <= 1e-6 * abs(saved["valid"]["loss"])
    assert evaluated["n_images"] == 1 and evaluated["n_gt"] > 0 and 0.0 <= evaluated["gt_localized_frac"] <= 1.0


def test_resume_retraces_the_uninterrupted_run(runs):
    _, whole, _, _, first, resumed = runs
    assert first["state"].step == 1 and resumed["state"].step == 2 and resumed["history"][-1]["step"] == 2
    ours, ref = resumed["state"].model.state_dict(), whole["state"].model.state_dict()
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    assert not torch.equal(first["state"].model.state_dict()["conf_head0.weight"], ref["conf_head0.weight"])


def test_epoch_scan_equals_the_per_step_run(runs, tmp_path, capsys):
    *_, first, _ = runs
    scanned = _run(tmp_path, "scan", 1, "--device_cache", "--epoch_scan", "--save_as", "scan")
    assert scanned["epoch_scan"] and scanned["device_cache"]["train"]["bytes"] > 0
    ours, ref = scanned["state"].model.state_dict(), first["state"].model.state_dict()
    assert scanned["state"].step == 1 and all(torch.equal(ours[k], ref[k]) for k in ref)
    capsys.readouterr()
    ignored = _run(tmp_path, "ignored", 0, "--epoch_scan", "--save_as", "other")
    assert not ignored["epoch_scan"] and "epoch_scan ignored: requires --device_cache" in capsys.readouterr().out


def test_ssd_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gpu_flags = [f for f in FLAGS if f not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ssd.main(gpu_flags + ["--epochs", "1", "--checkpoint_dir", str(tmp_path), "--log_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--model", "ssd"] + gpu_flags + ["--checkpoint_dir", str(tmp_path)])
