"""``train.main`` on image files with the JAX package's training options, on
the CPU: a WIDER FACE tree written here (JPEGs of several aspects, 1-3 faces
each, a 0-count entry), ``--letterbox --grad_accum_steps 2 --moment_dtype
bfloat16 --opt_layout grouped --rng_impl threefry``, dropout 0.3.

* Three mini-steps an epoch with k = 2, so the first epoch ends in the middle
  of an accumulation: one epoch, then a resume from its ``_last`` checkpoint
  for one more, must give the two-epoch run's model, moments, accumulator,
  counts and per-step losses exactly.
* ``--device_cache --epoch_scan`` (the epoch runner, uncaptured on the CPU)
  gives the same run bit for bit: letterbox training reaches the transform
  through the device-resident set too.
* The moments are bfloat16, and the checkpoint records their dtype and the layout.
* TensorBoard's event file holds the JAX package's tags
  (``Loss/train/<metric>`` at each flush, ``Perf/images_per_sec``,
  ``Loss/valid/<metric>``, ``Metric/mAP``) at the steps of ``metrics.jsonl``.
"""

import json
import os

import pytest
import torch

from object_detection_destr_tpu_torch.train import train as train_cli
from object_detection_destr_tpu_torch.train.checkpoint import _load

from test_torch_datasets import write_widerface

SIZES = ((48, 64), (64, 40), (56, 56), (40, 60), (60, 52), (44, 44))
RUN = ["--device", "cpu", "--dataset", "widerface", "--letterbox", "--grad_accum_steps", "2",
       "--moment_dtype", "bfloat16", "--opt_layout", "grouped", "--rng_impl", "threefry",
       "--batch_size", "2", "--image_size", "64", "--num_encoder_blocks", "2", "--num_decoder_blocks", "2",
       "--hidden_dim", "32", "--ffn_dim", "64", "--num_heads", "4", "--top_k", "4", "--augment_factor", "1",
       "--log_interval", "1", "--lr", "1e-3", "--lr_backbone", "0", "--seed", "5", "--save_as", "tiny"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wider")
    write_widerface(root, "train", sizes=SIZES[:5])  # 5 images + the 0-count entry: 3 batches of 2
    write_widerface(root, "val", sizes=SIZES[5:], seed=3)
    out = tmp_path_factory.mktemp("runs")
    common = RUN + ["--data_root", str(root)]
    dirs = {k: str(out / k) for k in ("whole", "split", "scan")}
    whole = train_cli.main(common + ["--epochs", "2", "--checkpoint_dir", dirs["whole"], "--log_dir", dirs["whole"]])
    first = train_cli.main(common + ["--epochs", "1", "--checkpoint_dir", dirs["split"], "--log_dir", dirs["split"]])
    mini_after_first = first["state"].optimizer.mini_step
    resumed = train_cli.main(common + ["--epochs", "1", "--checkpoint_dir", dirs["split"], "--log_dir",
                                       dirs["split"], "--resume", "--resume_from", "tiny_last"])
    scanned = train_cli.main(common + ["--epochs", "2", "--checkpoint_dir", dirs["scan"], "--log_dir", dirs["scan"],
                                       "--device_cache", "--epoch_scan"])
    return {"whole": whole, "resumed": resumed, "scanned": scanned, "dirs": dirs,
            "mini_after_first": mini_after_first}


def _train_losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    return [(r["step"], r["loss"]) for r in records if r.get("prefix") == "train"]


def test_resume_in_mid_accumulation_retraces_the_run(runs):
    whole, resumed = runs["whole"], runs["resumed"]
    assert runs["mini_after_first"] == 1  # epoch 1 ended between the two mini-steps of update 2
    assert resumed["state"].step == whole["state"].step == 6
    for other in (resumed, runs["scanned"]):
        assert other["epoch_scan"] == (other is runs["scanned"])
        ours, ref = other["state"].model.state_dict(), whole["state"].model.state_dict()
        assert all(torch.equal(ours[k], ref[k]) for k in ref)
        a, b = other["state"].optimizer, whole["state"].optimizer
        assert (a.count, a.mini_step) == (b.count, b.mini_step) == (3, 0)
        for name in b.m:
            assert torch.equal(a.m[name], b.m[name]) and torch.equal(a.v[name], b.v[name])
        assert torch.equal(a.accumulated, b.accumulated)
    assert _train_losses(runs["dirs"]["split"]) == _train_losses(runs["dirs"]["whole"]) \
        == _train_losses(runs["dirs"]["scan"])
    assert all(m.dtype == torch.bfloat16 for m in whole["state"].optimizer.m.values())
    saved = _load(runs["dirs"]["split"], "tiny_last")["optimizer"]
    assert saved["moment_dtype"] == "bfloat16" and saved["layout"] == "grouped" and saved["mini_step"] == 0


def test_tensorboard_holds_the_jax_tags(runs):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    log_dir = runs["dirs"]["whole"]
    acc = EventAccumulator(log_dir)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    train_keys = ("loss", "loss_model", "loss_det", "loss_class", "loss_ciou")
    expected = {f"Loss/train/{k}" for k in train_keys} | {"Perf/images_per_sec", "Metric/mAP"} \
        | {f"Loss/valid/{k}" for k in ("loss_model", "loss_det", "loss_class", "loss_ciou")}
    assert tags == expected
    assert [e.step for e in acc.Scalars("Loss/train/loss")] == [s for s, _ in _train_losses(log_dir)]
    assert [e.step for e in acc.Scalars("Metric/mAP")] == [3, 6]
