"""The epoch runner (train/epoch_scan.py) on the CPU, where it runs its
captured body uncaptured, against the per-step loop it replaces, and the
trainer with ``--device_cache`` / ``--epoch_scan`` / ``--profile_dir``
against the per-step trainer.

The runner's body is the per-step path's operations in the same order
(gather, transform with the generator seeded from the step, core with the
dropout stream reseeded from the step, EMA), so parameters, EMA and metrics
are compared exactly, as are whole trainer runs: a device-cached run and a
scanned one train on the same batches, draws and arithmetic as the host
loader's run. This mirrors the JAX package's ``test_runner_matches_per_step_loop``
and ``test_runner_ema_carry`` (tests/test_epoch_scan.py).
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from object_detection_destr_tpu_torch.models.destr.layers import DropoutRng
from object_detection_destr_tpu_torch.train import train as train_cli
from object_detection_destr_tpu_torch.train.driver import _make_ema
from object_detection_destr_tpu_torch.train.epoch_scan import EpochRunner
from object_detection_destr_tpu_torch.train.state import TrainState


class _Model(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.full((3,), 2.0))


def _core(state, batch):
    """A toy step: a metric of the batch and one draw of the dropout stream,
    w -= 0.01 (m + 0.001 sum w) in place."""
    noise = torch.rand((), generator=state.rng.generator)
    m = batch["images"].mean() + 0.1 * batch["boxes"].mean() + 0.01 * noise
    with torch.no_grad():
        state.model.w.sub_(0.01 * (m + 0.001 * state.model.w.sum()))
    return {"loss": m, "noise": noise}


def _transform(raw, generator):
    return {"images": raw["images"] + torch.rand((), generator=generator), "boxes": raw["boxes"]}


def _data(n=12, hw=4):
    rng = np.random.default_rng(0)
    return {"images": torch.from_numpy(rng.normal(size=(n, hw, hw, 3)).astype(np.float32)),
            "boxes": torch.from_numpy(rng.uniform(size=(n, 2, 4)).astype(np.float32))}


def _aug_seed(step):
    return 1000 + 3 * step


def _state():
    return TrainState(model=_Model(), optimizer=None, rng=DropoutRng(4))


def _per_step(state, data, order, base, ema=None):
    generator = torch.Generator()
    metrics = []
    for i, row in enumerate(order):
        state.rng.begin_step(base + i)
        generator.manual_seed(_aug_seed(base + i))
        raw = {k: v.index_select(0, torch.from_numpy(row)) for k, v in data.items()}
        metrics.append(_core(state, _transform(raw, generator)))
        if ema is not None:
            ema[1](ema[0], state.model)
        state.step = base + i + 1
    return {k: np.array([float(m[k]) for m in metrics], np.float32) for k in metrics[0]}


@pytest.mark.parametrize("ema_decay", [None, 0.9])
def test_runner_matches_per_step_loop(ema_decay):
    data = _data()
    order = np.asarray([[0, 3], [7, 1], [5, 11], [2, 9]], np.int64)
    base = 17
    ref, ours = _state(), _state()
    emas = []
    for st in (ref, ours):
        if ema_decay is None:
            emas.append(None)
        else:
            init, update = _make_ema(ema_decay)
            emas.append((init(st.model), update))
    ref.step = ours.step = base
    want = _per_step(ref, data, order, base, emas[0])
    runner = EpochRunner(ours, _core, _transform, data, _aug_seed, steps_per_epoch=6, ema=emas[1])
    seen = []
    got = runner.run(order, base, after_step=lambda: seen.append(ours.step))
    assert ours.step == ref.step == base + 4 and seen == [18, 19, 20, 21]
    assert runner.graph is None  # nothing is captured on the CPU
    assert sorted(got) == ["loss", "noise"] and all(v.shape == (4,) for v in got.values())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch.equal(ours.model.w, ref.model.w)
    assert len(set(want["noise"].tolist())) == 4  # each step its own dropout draw
    if ema_decay is not None:
        assert torch.equal(emas[1][0][0], emas[0][0][0])
        assert not torch.equal(emas[1][0][0], ours.model.w.detach())

    # the next epoch, partly resumed: the rows after a start, the steps after the state's
    more = np.asarray([[4, 6], [8, 10]], np.int64)
    want = _per_step(ref, data, more, ref.step, emas[0])
    got = runner.run(more, ours.step)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch.equal(ours.model.w, ref.model.w) and ours.step == base + 6


def test_runner_rejects_a_longer_epoch():
    runner = EpochRunner(_state(), _core, _transform, _data(), _aug_seed, steps_per_epoch=2)
    with pytest.raises(ValueError, match="more than"):
        runner.run(np.zeros((3, 2), np.int64), 0)


RUN = ["--device", "cpu", "--batch_size", "2", "--image_size", "64", "--synthetic_size", "67",
       "--num_encoder_blocks", "2", "--num_decoder_blocks", "2", "--hidden_dim", "32", "--ffn_dim", "64",
       "--num_heads", "4", "--top_k", "4", "--num_train_samples", "4", "--num_valid_samples", "2",
       "--augment_factor", "1", "--log_interval", "1", "--lr", "1e-3", "--lr_backbone", "0", "--seed", "5",
       "--ema_decay", "0.9", "--skip_nonfinite", "3", "--grad_clip_norm", "0.1"]


def _train_log(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != "time"} for r in rows if r.get("prefix") == "train"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two epochs each: the host loader per step, the device cache per step,
    the device cache with scanned epochs, and one scanned epoch resumed for
    one more; and a profiled per-step run."""
    d = tmp_path_factory.mktemp("runs")
    out = {}
    for name, extra in (("host", []), ("cache", ["--device_cache"]),
                        ("scan", ["--device_cache", "--epoch_scan"])):
        out[name] = train_cli.main(RUN + extra + ["--epochs", "2", "--checkpoint_dir", str(d / name),
                                                  "--log_dir", str(d / name)])
    scan = ["--device_cache", "--epoch_scan", "--checkpoint_dir", str(d / "resumed"), "--log_dir", str(d / "resumed")]
    train_cli.main(RUN + scan + ["--epochs", "1"])
    out["resumed"] = train_cli.main(RUN + scan + ["--epochs", "1", "--resume", "--resume_from", "model_weights_last"])
    out["profiled"] = train_cli.main(RUN + ["--num_train_samples", "12", "--epochs", "1", "--epoch_scan",
                                            "--device_cache", "--profile_dir", str(d / "trace"),
                                            "--checkpoint_dir", str(d / "profiled"), "--log_dir", str(d / "profiled")])
    out["logs"] = {name: _train_log(d / name) for name in ("host", "cache", "scan", "resumed")}
    out["trace_dir"] = d / "trace"
    return out


@pytest.mark.parametrize("name", ["cache", "scan", "resumed"])
def test_train_destr_runs_match_the_per_step_run(runs, name):
    ref, ours = runs["host"], runs[name]
    assert ours["state"].step == ref["state"].step == 4
    assert ours["epoch_scan"] == (name != "cache") and ref["epoch_scan"] is False
    assert (ours["device_cache"] is not None) and ref["device_cache"] is None
    theirs = ref["state"].model.state_dict()
    assert all(torch.equal(v, theirs[k]) for k, v in ours["state"].model.state_dict().items())
    assert ours["state"].optimizer.count == 4
    assert ours["history"][-1]["mAP"] == ref["history"][-1]["mAP"]
    assert ours["history"][-1]["valid"] == ref["history"][-1]["valid"]
    assert runs["logs"][name] == runs["logs"]["host"]  # the resumed run's log holds both of its runs


def test_profile_dir_traces_steps_2_to_4(runs):
    """--profile_dir turns --epoch_scan off, traces steps 2-4 of epoch 0
    (three marked steps) and writes a trace that parses."""
    profiled = runs["profiled"]
    assert profiled["epoch_scan"] is False and profiled["state"].step == 6
    profile = profiled["profile"]
    assert [s["label"] for s in profile["steps"]] == ["2", "3", "4"]
    assert os.path.dirname(profile["path"]) == str(runs["trace_dir"])
    assert profile["idle_share"] >= 0.0 and profile["window_s"] >= profile["busy_s"] >= 0.0
