"""Both mAP metrics as one device program a batch (``losses/metrics.py``
over ``ops/cuda/greedy_match.py``) and the captured eval step
(``train/steps.py::CapturedEvalStep``), on the CPU.

* The greedy walk's plain version (what the CPU runs, and what the CUDA
  kernel is held to on the card) through both metrics against JAX's own
  ``lax.scan``s on the same numpy inputs: ``_update_all_classes`` (through
  ``MeanAveragePrecision.update``) and ``_coco_batch_records`` at C = 1, 20
  and 80; tp / fp / num_gts and the records exactly equal (COCO's scores,
  sigmoids of two libraries, within 1e-6), both APs within 1e-9. JAX's
  ``_coco_batch_records`` unrolls a Python loop over the classes, so its
  compile grows with C (about 2 s at C = 20 and 10 s at C = 80 on one
  core); its classes are independent, so at C = 20 and 80 its records are
  its one-class program run on each class's slice of the same inputs (the
  grid cases below run its two-class program as it is).
* ``hypothesis`` cases on a coarse grid of boxes and scores: ties of score
  and IoU, IoUs exactly at a threshold, NaN outputs, images with no target,
  more predictions on one target than targets.
* No host copy in the 11-point update (its state stays a tensor on the
  outputs' device), one in COCO's.
* The captured eval step on the CPU runs the eager step: equal outputs for
  DESTR and SSD.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.losses.metrics import CocoAveragePrecision as JaxCoco  # noqa: E402
from object_detection_destr_tpu.losses.metrics import MeanAveragePrecision as JaxMap  # noqa: E402
from object_detection_destr_tpu.losses.metrics import _coco_batch_records as jax_records  # noqa: E402
from object_detection_destr_tpu_torch.config import DestrConfig, SSDConfig, TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.losses.metrics import (  # noqa: E402
    CocoAveragePrecision,
    MeanAveragePrecision,
    _coco_batch_records,
)
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.models.ssd import build_ssd  # noqa: E402
from object_detection_destr_tpu_torch.models.ssd.model import SSD  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda.greedy_match import greedy_match, greedy_match_reference  # noqa: E402
from object_detection_destr_tpu_torch.train.state import TrainState  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import (  # noqa: E402
    CapturedEvalStep,
    make_destr_eval_step,
    make_ssd_eval_step,
)

THRESHOLDS = CocoAveragePrecision.IOU_THRESHOLDS
GRID = np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)


def _batch(rng, b, n, t, channels, label_classes):
    """Outputs scattered around the targets (hits at every threshold), with
    a duplicated box and a duplicated score row, and an image without
    ground truth."""
    xy = rng.uniform(0.05, 0.6, (b, t, 2))
    wh = rng.uniform(0.1, 0.35, (b, t, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(size=(b, t)) < 0.8
    valid[0] = False
    labels = rng.integers(0, label_classes, (b, t)).astype(np.int32)
    src = rng.integers(0, t, (b, n))
    rows = np.arange(b)[:, None]
    centre = (gt[rows, src, :2] + gt[rows, src, 2:]) / 2 + rng.normal(0, 0.02, (b, n, 2))
    size = (gt[rows, src, 2:] - gt[rows, src, :2]) * rng.uniform(0.8, 1.2, (b, n, 2))
    boxes = np.stack([centre[..., 0], centre[..., 1], size[..., 1], size[..., 0]], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]
    logits = rng.normal(0, 2, (b, n, channels)).astype(np.float32)
    logits[:, 3] = logits[:, 2]
    # the true class leads on most predictions, so every class is selected
    logits[rows, np.arange(n)[None, :], labels[rows, src]] += 3.0
    return {"pred_class": logits, "pred_boxes": np.clip(boxes, 0.0, 1.0)}, {
        "boxes": gt, "labels": labels, "valid": valid}


def _torch(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _map_pair(num_cls, num_pred, batches):
    """The port's and JAX's 11-point states after ``batches``, and their APs."""
    ours, ref = MeanAveragePrecision(num_cls, num_pred=num_pred), JaxMap(num_cls, num_pred=num_pred)
    s_ours, s_ref = ours.init_state(), ref.init_state()
    for outputs, targets in batches:
        s_ours = ours.update(s_ours, _torch(outputs), _torch(targets))
        s_ref = ref.update(s_ref, _jax(outputs), _jax(targets))
    return s_ours, s_ref, ours.compute(s_ours), ref.compute(s_ref)


def _jax_coco_records(outputs, targets, num_cls, max_dets, per_class):
    if not per_class:
        return [np.asarray(x) for x in jax_records(_jax(outputs), _jax(targets), num_cls=num_cls,
                                                   max_dets=max_dets, iou_thresholds=THRESHOLDS)]
    parts = []
    for c in range(num_cls):
        one = {**outputs, "pred_class": outputs["pred_class"][..., c:c + 1]}
        labels = np.where(targets["labels"] == c, 0, -1).astype(np.int32)
        parts.append(jax_records(_jax(one), _jax({**targets, "labels": labels}), num_cls=1, max_dets=max_dets,
                                 iou_thresholds=THRESHOLDS))
    return [np.concatenate([np.asarray(p[i]) for p in parts], axis=1) for i in range(3)]


@pytest.mark.parametrize("num_cls", [1, 20, 80])
def test_map_matches_jax_scan(num_cls):
    rng = np.random.default_rng(num_cls)
    batches = [_batch(rng, b=4, n=48, t=12, channels=num_cls + 1, label_classes=num_cls) for _ in range(2)]
    s_ours, s_ref, ap, ap_ref = _map_pair(num_cls, 16, batches)
    for key in ("tp", "fp", "num_gts"):
        assert isinstance(s_ours[key], torch.Tensor)
        np.testing.assert_array_equal(s_ours[key].numpy(), np.asarray(s_ref[key]), err_msg=key)
    assert s_ours["tp"].sum() > 0 and s_ours["fp"].sum() > 0
    assert abs(ap - ap_ref) <= 1e-9 and ap_ref > 0


@pytest.mark.parametrize("num_cls", [1, 20, 80])
def test_coco_records_match_jax_scan(num_cls):
    rng = np.random.default_rng(100 + num_cls)
    batches = [_batch(rng, b=3, n=24, t=10, channels=num_cls, label_classes=num_cls) for _ in range(2)]
    ours, ref = CocoAveragePrecision(num_cls, 8), JaxCoco(num_cls, 8)
    for outputs, targets in batches:
        got = _coco_batch_records(_torch(outputs), _torch(targets), num_cls=num_cls, max_dets=8,
                                  iou_thresholds=THRESHOLDS)
        want = _jax_coco_records(outputs, targets, num_cls, 8, per_class=num_cls > 1)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        ours.update(_torch(outputs), _torch(targets))
        ref._scores.append(want[0])
        ref._tp.append(want[1])
        ref._num_gts += want[2].sum(axis=0)
    assert sum(t.sum() for t in ours._tp) > 0
    assert abs(ours.compute() - ref.compute()) <= 1e-9 and ref.compute() > 0


@st.composite
def _grid_batch(draw):
    """B=3 images, N=6 predictions, T=3 targets, 2 classes, boxes on a
    0.25 grid (exact IoUs of 0.5 and ties), scores from 3 values, some
    images without a target, all predictions possibly on one target, and
    NaN outputs."""
    b, n, t = 3, 6, 3

    def box():
        x0, y0 = draw(st.sampled_from(GRID[:3])), draw(st.sampled_from(GRID[:3]))
        x1, y1 = draw(st.sampled_from(GRID[GRID > x0])), draw(st.sampled_from(GRID[GRID > y0]))
        return [x0, y0, x1, y1]

    gt = np.array([[box() for _ in range(t)] for _ in range(b)], np.float32)
    valid = np.array(draw(st.lists(st.booleans(), min_size=b * t, max_size=b * t)), bool).reshape(b, t)
    labels = np.array(draw(st.lists(st.integers(0, 1), min_size=b * t, max_size=b * t)), np.int32).reshape(b, t)
    xyxy = np.array([[box() for _ in range(n)] for _ in range(b)], np.float32)
    if draw(st.booleans()):  # every prediction on the first target
        xyxy[:] = gt[:, :1]
    boxes = np.stack([(xyxy[..., 0] + xyxy[..., 2]) / 2, (xyxy[..., 1] + xyxy[..., 3]) / 2,
                      xyxy[..., 3] - xyxy[..., 1], xyxy[..., 2] - xyxy[..., 0]], -1).astype(np.float32)
    logits = np.array(draw(st.lists(st.sampled_from([-1.0, 0.0, 2.0]), min_size=b * n * 3, max_size=b * n * 3)),
                      np.float32).reshape(b, n, 3)
    nan = draw(st.sampled_from(["none", "logits", "boxes"]))
    if nan == "logits":
        logits[1] = np.nan
    elif nan == "boxes":
        boxes[2, :2] = np.nan
    return {"pred_class": logits, "pred_boxes": boxes}, {"boxes": gt, "labels": labels, "valid": valid}


@settings(max_examples=15, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(batch=_grid_batch())
def test_grid_cases_match_jax_scan(batch):
    outputs, targets = batch
    s_ours, s_ref, ap, ap_ref = _map_pair(2, 6, [batch])
    for key in ("tp", "fp", "num_gts"):
        np.testing.assert_array_equal(s_ours[key].numpy(), np.asarray(s_ref[key]), err_msg=key)
    assert abs(ap - ap_ref) <= 1e-9
    got = _coco_batch_records(_torch(outputs), _torch(targets), num_cls=2, max_dets=4, iou_thresholds=THRESHOLDS)
    want = _jax_coco_records({**outputs, "pred_class": outputs["pred_class"][..., :2]}, targets, 2, 4, False)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6, atol=0)


def test_walk_rules_on_planted_rows():
    """The two rules on hand-made rows: the 11-point rule misses on a taken
    best target, COCO's takes the next; a tie goes to the first target, a
    NaN row never hits, ranks past n_use never hit."""
    nan = float("nan")
    iou = torch.tensor([[[0.6, 0.6, -1.0], [0.7, 0.55, -1.0], [nan, 0.9, -1.0], [0.5, 0.2, -1.0]]])
    n_use = torch.tensor([3])
    eleven = greedy_match(iou, n_use, [0.5], skip_matched=False)[0, :, 0].tolist()
    coco = greedy_match(iou, n_use, [0.5, 0.6], skip_matched=True)[0].tolist()
    assert eleven == [True, False, False, False]
    assert coco == [[True, True], [True, False], [False, True], [False, False]]
    assert torch.equal(greedy_match_reference(iou, torch.tensor([4]), [0.5], True)[0, 3], torch.tensor([False]))


def _spy(monkeypatch):
    calls = {"cpu": 0, "numpy": 0, "item": 0}
    for name in calls:
        real = getattr(torch.Tensor, name)

        def counted(self, *args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return calls


def test_update_copies(monkeypatch):
    """The 11-point update copies nothing to the host; COCO's copies once."""
    outputs, targets = (_torch(d) for d in _batch(np.random.default_rng(7), b=2, n=12, t=5, channels=4,
                                                  label_classes=3))
    metric, coco = MeanAveragePrecision(3, num_pred=8), CocoAveragePrecision(3, 4)
    state = metric.init_state(torch.device("cpu"))
    calls = _spy(monkeypatch)
    state = metric.update(state, outputs, targets)
    assert calls == {"cpu": 0, "numpy": 0, "item": 0}
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in state.values())
    coco.update(outputs, targets)
    assert calls["cpu"] == 1 and calls["item"] == 0
    monkeypatch.undo()
    assert metric.compute(state) > 0 and coco.compute() > 0


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_captured_eval_steps_run_eagerly_on_cpu(monkeypatch):
    """DESTR's and SSD's eval steps through the wrapper equal the eager
    steps on the CPU (DESTR twice in a row). SSD keeps PyTorch's default
    initialization (its flax-like truncated normals take 2 s on the CPU and
    do not matter here)."""
    cfg = TrainConfig(batch_size=2)
    rng = np.random.default_rng(3)
    torch.manual_seed(0)
    destr = build_destr(DestrConfig(hidden_dim=32, num_heads=4, ffn_dim=64, num_encoder_blocks=1,
                                    num_decoder_blocks=1, top_k=4, dropout=0.0), "cpu")
    outputs, targets = _batch(rng, b=2, n=4, t=3, channels=2, label_classes=1)
    batch = {"images": torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32)),
             "pixel_valid": torch.ones((2, 64, 64), dtype=torch.bool), **_torch(targets)}
    state = TrainState(model=destr, optimizer=None, rng=None)
    step = make_destr_eval_step(cfg)
    wrapped = CapturedEvalStep(step)
    for _ in range(2):
        assert _equal(wrapped(state, batch), step(state, batch))
    ssd_cfg = SSDConfig(num_cls=2)
    monkeypatch.setattr(SSD, "_init_like_flax", lambda self: None)
    ssd = build_ssd(ssd_cfg, "cpu")
    xy = rng.uniform(0.2, 0.6, (1, 3, 2))
    cxcyhw = np.concatenate([xy, rng.uniform(0.1, 0.3, (1, 3, 2))], -1).astype(np.float32)
    ssd_batch = {"images": torch.from_numpy(rng.normal(size=(1, 300, 300, 3)).astype(np.float32)),
                 "boxes": torch.from_numpy(cxcyhw), "labels": torch.tensor([[0, 1, 1]]),
                 "valid": torch.tensor([[True, True, False]])}
    ssd_state = TrainState(model=ssd, optimizer=None, rng=None)
    step = make_ssd_eval_step(cfg, ssd_cfg)
    wrapped = CapturedEvalStep(step)
    assert _equal(wrapped(ssd_state, ssd_batch), step(ssd_state, ssd_batch))
    assert wrapped.replays == 0  # nothing captured on the CPU
