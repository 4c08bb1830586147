"""The port's validation slice against the JAX package and against itself.

* The eval step (``make_destr_eval_step``) against JAX's on one tiny DESTR
  whose random flax variables (BatchNorm statistics included) are carried
  across by ``models/convert.py::load_flax_variables``: float32, the matcher
  on the fused kernel's path on both sides (``OBJDET_FORCE_PALLAS_MATCHER=1``
  for the JAX step, as tests/test_torch_train_step.py sets it). Outputs within
  1e-4 of each tensor's largest value and losses within 1e-4 relative
  (float32 through a ResNet-50 and the transformer, summed in other orders).
* The whole sweep (eval transform, eval step, mAP, COCO AP) against a JAX
  sweep on the same raw batches of one loader: losses within 1e-4 relative
  and both APs within 1e-6 (tests/test_torch_metrics.py holds the metrics'
  records to equality on equal outputs).
* The EMA arithmetic, the checkpoint round trip and its ``.new`` / ``.old``
  fallback, a tiny CPU run of 2 epochs whose parameters equal bit for bit
  those of a 1-epoch run resumed for a second, and ``evaluate.main`` on the
  CPU, whose mAP equals the driver's at the saved epoch.
"""

import importlib.util
import os
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.config import DestrConfig as JaxDestrConfig  # noqa: E402
from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.data.datasets import build_dataset as jax_build_dataset  # noqa: E402
from object_detection_destr_tpu.data.loader import DetectionLoader as JaxLoader  # noqa: E402
from object_detection_destr_tpu.data.transforms import destr_eval_transform as jax_eval_transform  # noqa: E402
from object_detection_destr_tpu.losses.metrics import CocoAveragePrecision as JaxCoco  # noqa: E402
from object_detection_destr_tpu.losses.metrics import MeanAveragePrecision as JaxMap  # noqa: E402
from object_detection_destr_tpu.models.destr.model import build_destr as jax_build_destr  # noqa: E402
from object_detection_destr_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from object_detection_destr_tpu.train.steps import make_destr_eval_step as jax_make_eval_step  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig, TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.infer import evaluate  # noqa: E402
from object_detection_destr_tpu_torch.losses.metrics import CocoAveragePrecision, MeanAveragePrecision  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import load_flax_variables  # noqa: E402
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.train import train as train_cli  # noqa: E402
from object_detection_destr_tpu_torch.train.checkpoint import (  # noqa: E402
    restore_checkpoint,
    restore_for_inference,
    save_checkpoint,
)
from object_detection_destr_tpu_torch.train.driver import _make_ema, _parameters_swapped, _val_sweep  # noqa: E402
from object_detection_destr_tpu_torch.train.state import create_destr_state  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import make_destr_eval_step  # noqa: E402

from test_torch_modules import _random_variables  # noqa: E402

TINY = dict(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=2, num_decoder_blocks=2, top_k=4,
            dropout=0.0)
TRAIN = dict(lr=1e-4, lr_backbone=1e-5, batch_size=2, set_cost_class=1.0, set_cost_bbox=2.5,
             set_cost_ciou=1.0, class_norm="boxes", grad_clip_norm=0.1, skip_nonfinite_updates=100)
SIZE = 64
RESIZE_TO = int(SIZE * 672 / 640)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's operations are too small to gain from PyTorch's
    intra-op threads; one thread keeps this module's training runs from
    crowding the other test workers' cores (same results, about the same
    time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """A tiny JAX model with random variables and the port's copy of it."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OBJDET_FORCE_PALLAS_MATCHER", "1")
    rng = np.random.default_rng(4)
    jax_model = jax_build_destr(JaxDestrConfig(**TINY, use_flash_attention=True))
    variables = _random_variables(jax_model, rng, jnp.zeros((1, SIZE, SIZE, 3)))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, variables["params"]),
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), opt_state=(),
                           rng=jax.random.key(0))
    model = load_flax_variables(build_destr(DestrConfig(**TINY), "cpu"), variables)
    state = create_destr_state(model, TrainConfig(**TRAIN), steps_per_epoch=4)
    yield jax_make_eval_step(jax_model, JaxTrainConfig(**TRAIN)), jstate, make_destr_eval_step(TrainConfig(**TRAIN)), state
    mp.undo()


def _raw_batches(n_batches=2, seed=2):
    """Letterboxed raw batches of the valid split, from the JAX loader."""
    ds = jax_build_dataset("synthetic", "dataset", "valid", image_size=RESIZE_TO, num_samples=2 * n_batches,
                           seed=seed, aspect_ratios=(1.0, 0.7, 1.4))
    return list(JaxLoader(ds, batch_size=2, canvas_size=RESIZE_TO, max_targets=8, letterbox=True, seed=seed + 1))


def _close(ours, ref, tol, name):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    err = np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= tol, f"{name}: relative error {err:.2e}"


def test_eval_step_matches_jax(pair):
    jstep, jstate, step, state = pair
    raw = _raw_batches(1)[0]
    jbatch = jax_eval_transform(*(jnp.asarray(raw[k]) for k in ("images", "boxes", "labels", "valid", "content_hw")),
                                resize_to=RESIZE_TO, out_size=SIZE)
    ref_out, ref_metrics = jstep(jstate, jbatch)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    assert state.model.training
    out, metrics = step(state, batch)
    assert state.model.training  # back in train mode
    assert not out["pred_class"].requires_grad
    for key in ("pred_class", "pred_boxes"):
        _close(out[key].numpy(), ref_out[key], 1e-4, key)
    assert sorted(metrics) == sorted(ref_metrics)
    for k, v in ref_metrics.items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-4 * max(abs(float(v)), 1e-3), k


def test_val_sweep_matches_jax(pair):
    jstep, jstate, step, state = pair
    raws = _raw_batches(2)
    ref_map, ref_coco = JaxMap(1, num_pred=TINY["top_k"]), JaxCoco(1)
    m_state, ref_means = ref_map.init_state(), []
    for raw in raws:
        jbatch = jax_eval_transform(*(jnp.asarray(raw[k]) for k in ("images", "boxes", "labels", "valid",
                                                                    "content_hw")),
                                    resize_to=RESIZE_TO, out_size=SIZE)
        outputs, m = jstep(jstate, jbatch)
        targets = {k: jbatch[k] for k in ("boxes", "labels", "valid")}
        m_state = ref_map.update(m_state, outputs, targets)
        ref_coco.update(outputs, targets)
        ref_means.append({k: float(v) for k, v in m.items()})
    ours_map, ours_coco = MeanAveragePrecision(1, num_pred=TINY["top_k"]), CocoAveragePrecision(1)
    means, mean_ap, coco_ap, seconds = _val_sweep(state, raws, step, ours_map, ours_coco, torch.device("cpu"),
                                                  RESIZE_TO, SIZE)
    for k, v in means.items():
        ref = float(np.mean([r[k] for r in ref_means]))
        assert abs(v - ref) <= 1e-4 * max(abs(ref), 1e-3), k
    assert abs(mean_ap - ref_map.compute(m_state)) <= 1e-6
    assert abs(coco_ap - ref_coco.compute()) <= 1e-6 and seconds > 0
    assert ours_coco._num_gts.sum() == ref_coco._num_gts.sum() > 0


def test_ema_arithmetic():
    """ema = d * ema + (1 - d) * params over the parameters, within one
    float32 rounding of the formula; BatchNorm statistics are not in it; the
    swap puts the EMA in and the live values back bit for bit."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    init, update = _make_ema(0.9)
    ema = init(model)
    assert len(ema) == len(list(model.parameters()))
    expect = [e.double() for e in ema]
    for _ in range(3):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.randn_like(p))
        update(ema, model)
        expect = [0.9 * e + (1 - 0.9) * p.detach().double() for e, p in zip(expect, model.parameters())]
        for e, x in zip(ema, expect):
            assert torch.allclose(e.double(), x, rtol=2e-7, atol=1e-7)
    live = [p.detach().clone() for p in model.parameters()]
    with _parameters_swapped(model, ema):
        assert all(torch.equal(p, e) for p, e in zip(model.parameters(), ema))
    assert all(torch.equal(p, x) for p, x in zip(model.parameters(), live))


def test_checkpoint_round_trip_and_fallback(pair):
    *_, state = pair
    with tempfile.TemporaryDirectory() as d:
        state.optimizer.count, state.step = 3, 7
        first = {k: v.clone() for k, v in state.model.state_dict().items()}
        path = save_checkpoint(d, "ck", state, {"epoch": 1, "step": 0}, 0.5)
        save_checkpoint(d, "ck", state, {"epoch": 2, "step": 1}, 0.25)  # the stage-and-swap path
        assert sorted(os.listdir(d)) == ["ck"]
        state.rng.begin_step(7)  # the dropout stream is a function of the step
        expected = (state.rng.seed(), torch.rand(4, generator=state.rng.generator))
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        state.step, state.optimizer.count = 0, 0
        restored = restore_checkpoint(d, "ck", state)
        assert restored["loader"] == {"epoch": 2, "step": 1} and restored["best_val"] == 0.25
        assert state.step == 7 and state.optimizer.count == 3
        assert all(torch.equal(v, first[k]) for k, v in state.model.state_dict().items())
        state.rng.begin_step(state.step)
        assert torch.equal(state.rng.seed(), expected[0])
        assert torch.equal(torch.rand(4, generator=state.rng.generator), expected[1])
        assert sorted(restore_for_inference(d, "ck")) == sorted(first)
        # a crash between the swap's two renames leaves .new (then .old) only
        for suffix in (".new", ".old"):
            os.rename(path if suffix == ".new" else path + ".new", path + suffix)
            assert restore_checkpoint(d, "ck", state)["best_val"] == 0.25
        os.remove(path + ".old")
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(d, "ck", state)


RUN = ["--device", "cpu", "--batch_size", "2", "--image_size", "64", "--synthetic_size", "67",
       "--num_encoder_blocks", "2", "--num_decoder_blocks", "2", "--hidden_dim", "32", "--ffn_dim", "64",
       "--num_heads", "4", "--top_k", "4", "--num_train_samples", "4", "--num_valid_samples", "2",
       "--augment_factor", "1", "--log_interval", "1", "--lr", "1e-3", "--lr_backbone", "0", "--seed", "5"]


@pytest.fixture(scope="module")
def runs():
    """Two epochs at once, and one epoch resumed for one more, dropout on
    (0.3), with the EMA: the resumed run must retrace the uninterrupted one."""
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "a"), os.path.join(d, "b")
        common = RUN + ["--ema_decay", "0.9", "--save_as", "tiny"]
        whole = train_cli.main(common + ["--epochs", "2", "--checkpoint_dir", a, "--log_dir", a, "--coco_eval"])
        first = train_cli.main(common + ["--epochs", "1", "--checkpoint_dir", b, "--log_dir", b])
        resumed = train_cli.main(common + ["--epochs", "1", "--checkpoint_dir", b, "--log_dir", b, "--resume",
                                           "--resume_from", "tiny_last"])
        evaluated = evaluate.main(RUN + ["--checkpoint_dir", a, "--resume_from", "tiny"])
        yield whole, first, resumed, evaluated, sorted(os.listdir(a))


def test_resume_retraces_the_uninterrupted_run(runs):
    whole, first, resumed, _, files = runs
    # the log directory also holds TensorBoard's event file (train/logging_utils.py)
    events = [f for f in files if f.startswith("events.out.tfevents.")]
    assert [f for f in files if f not in events] == ["metrics.jsonl", "tiny", "tiny_ema", "tiny_last"]
    assert len(events) == (1 if importlib.util.find_spec("tensorboard") else 0)
    assert first["state"].step == 2 and resumed["state"].step == whole["state"].step == 4
    ours, ref = resumed["state"].model.state_dict(), whole["state"].model.state_dict()
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    assert not torch.equal(first["state"].model.state_dict()["cls_embed.weight"], ref["cls_embed.weight"])
    assert resumed["state"].optimizer.count == 4
    assert resumed["history"][-1]["step"] == 4 and len(whole["history"]) == 2


@pytest.mark.parametrize("argv,kind", [
    ([], "destr"), (["--model", "destr"], "destr"), (["--model", "ssd"], "ssd"), (["--model=ssd"], "ssd"),
    (["--device", "cpu", "--model=ssd"], "ssd"),
])
def test_evaluate_main_picks_the_model_flag_set(monkeypatch, capsys, argv, kind):
    """``--model X`` and ``--model=X`` anywhere pick the evaluator and its
    trainer's flag set; without it, DESTR's."""
    seen = {}

    def fake(name):
        def run(config, resume_from, device):
            seen.update(kind=name, resume_from=resume_from)
            return {"checkpoint": resume_from, "map": 0.5}
        return run

    monkeypatch.setattr(evaluate, "evaluate_destr", fake("destr"))
    monkeypatch.setattr(evaluate, "evaluate_ssd", fake("ssd"))
    result = evaluate.main(argv + ["--resume_from", "w", "--device", "cpu"])
    assert seen["kind"] == kind and result == {"checkpoint": "w", "map": 0.5}
    assert '"map": 0.5' in capsys.readouterr().out


@pytest.mark.parametrize("argv,code,text", [
    (["--resume_from", "w", "--model"], 2, "argument --model: expected one argument"),
    (["--model", "yolo"], 2, "argument --model: invalid choice: 'yolo'"),
    (["--help"], 0, "--model {destr,ssd}"),
])
def test_evaluate_main_model_flag_errors_and_help(capsys, argv, code, text):
    """A trailing ``--model`` or an unknown model exits 2 with argparse's
    message; ``--help`` lists ``--model``."""
    with pytest.raises(SystemExit) as exc:
        evaluate.main(argv)
    assert exc.value.code == code
    out = capsys.readouterr()
    assert text in (out.err if code else out.out)


def test_evaluate_main_reproduces_the_drivers_map(runs):
    whole, *_, evaluated, _ = runs
    saved = [h for h in whole["history"] if h["valid"]["loss_model"] == whole["best_val"]][0]
    assert abs(evaluated["map"] - saved["mAP"]) <= 1e-6
    assert abs(evaluated["coco_map"] - saved["coco_mAP"]) <= 1e-6
    assert evaluated["n_images"] == 2 and evaluated["checkpoint"] == "tiny"
    with pytest.raises(SystemExit):  # --model ssd takes the SSD trainer's flags, which have no --top_k
        evaluate.main(["--model", "ssd", "--top_k", "4"])
