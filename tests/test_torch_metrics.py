"""The port's metrics (``losses/metrics.py``) against the JAX package's on
the same outputs and targets (numpy, seeded): the 11-point
``MeanAveragePrecision`` with its rank histograms ``tp`` / ``fp`` and
``num_gts`` exactly equal, and ``CocoAveragePrecision`` with its per-batch
hit records and ground-truth counts exactly equal and its scores (sigmoids
of two libraries) within 1e-6 relative; both APs within 1e-6 (the same float64 host arithmetic on
equal records). COCO also against the hand-derived goldens of
tests/fixtures/coco_ap_golden.json (1e-6, as tests/test_coco_ap.py).

The outputs hold exact ties (equal scores, duplicate boxes) so the sort and
top-k tie orders and the greedy rules are exercised, and images without
ground truth."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.losses.metrics import CocoAveragePrecision as JaxCoco  # noqa: E402
from object_detection_destr_tpu.losses.metrics import MeanAveragePrecision as JaxMap  # noqa: E402
from object_detection_destr_tpu_torch.losses.metrics import (  # noqa: E402
    CocoAveragePrecision,
    MeanAveragePrecision,
)
from torch_threads import one_torch_thread  # noqa: E402, F401


def _batch(rng, b=4, n=24, t=6, num_cls=2):
    """Predictions scattered around the targets so that some match at IoU
    0.5 and above; duplicated boxes and scores make ties."""
    xy = rng.uniform(0.05, 0.6, (b, t, 2))
    wh = rng.uniform(0.1, 0.35, (b, t, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(size=(b, t)) < 0.7
    valid[0] = False  # an image without ground truth
    labels = rng.integers(0, max(num_cls - 1, 1), (b, t)).astype(np.int32)
    src = rng.integers(0, t, (b, n))
    centre = (gt[np.arange(b)[:, None], src, :2] + gt[np.arange(b)[:, None], src, 2:]) / 2
    size = gt[np.arange(b)[:, None], src, 2:] - gt[np.arange(b)[:, None], src, :2]
    centre = centre + rng.normal(0, 0.03, centre.shape)
    size = size * rng.uniform(0.7, 1.3, size.shape)
    # cxcyhw: (cx, cy, h, w)
    boxes = np.stack([centre[..., 0], centre[..., 1], size[..., 1], size[..., 0]], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]  # a duplicate prediction
    logits = rng.normal(0, 2, (b, n, num_cls)).astype(np.float32)
    logits[:, 3] = logits[:, 2]  # equal scores
    return {"pred_class": logits, "pred_boxes": np.clip(boxes, 0.0, 1.0)}, {
        "boxes": gt, "labels": labels, "valid": valid}


@pytest.mark.parametrize("num_cls,num_pred", [(1, 300), (2, 10), (3, 300)])
def test_map_matches_jax(num_cls, num_pred):
    rng = np.random.default_rng(num_cls)
    ours, ref = MeanAveragePrecision(num_cls, num_pred=num_pred), JaxMap(num_cls, num_pred=num_pred)
    s_ours, s_ref = ours.init_state(), ref.init_state()
    for _ in range(3):
        outputs, targets = _batch(rng, num_cls=num_cls + 1)
        s_ours = ours.update(s_ours, {k: torch.from_numpy(v) for k, v in outputs.items()},
                             {k: torch.from_numpy(v) for k, v in targets.items()})
        s_ref = ref.update(s_ref, {k: jnp.asarray(v) for k, v in outputs.items()},
                           {k: jnp.asarray(v) for k, v in targets.items()})
    for key in ("tp", "fp", "num_gts"):
        np.testing.assert_array_equal(s_ours[key], np.asarray(s_ref[key]), err_msg=key)
    assert s_ours["tp"].sum() > 0 and s_ours["fp"].sum() > 0
    assert abs(ours.compute(s_ours) - ref.compute(s_ref)) <= 1e-6


@pytest.mark.parametrize("num_cls,max_dets", [(1, 100), (2, 8)])
def test_coco_matches_jax(num_cls, max_dets):
    rng = np.random.default_rng(10 + num_cls)
    ours, ref = CocoAveragePrecision(num_cls, max_dets), JaxCoco(num_cls, max_dets)
    for _ in range(3):
        outputs, targets = _batch(rng, num_cls=num_cls)
        ours.update({k: torch.from_numpy(v) for k, v in outputs.items()},
                    {k: torch.from_numpy(v) for k, v in targets.items()})
        ref.update({k: jnp.asarray(v) for k, v in outputs.items()}, {k: jnp.asarray(v) for k, v in targets.items()})
    for a, b in zip(ours._scores, ref._scores):  # sigmoids of two libraries: within an ulp or two
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    for a, b in zip(ours._tp, ref._tp):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours._num_gts, ref._num_gts)
    assert sum(t.sum() for t in ours._tp) > 0
    assert abs(ours.compute() - ref.compute()) <= 1e-6


def test_coco_hand_derived_goldens():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "coco_ap_golden.json")
    with open(path) as f:
        doc = json.load(f)
    assert list(CocoAveragePrecision.IOU_THRESHOLDS) == doc["iou_thresholds"]
    for case in doc["cases"]:
        metric = CocoAveragePrecision(num_cls=case["num_cls"], max_dets_per_image=case["max_dets"])
        for b in case["batches"]:
            metric.update({k: torch.tensor(v, dtype=torch.float32) for k, v in b["outputs"].items()},
                          {"boxes": torch.tensor(b["targets"]["boxes"], dtype=torch.float32),
                           "labels": torch.tensor(b["targets"]["labels"], dtype=torch.int32),
                           "valid": torch.tensor(b["targets"]["valid"], dtype=torch.bool)})
        assert metric.compute() == pytest.approx(case["expected_ap"], abs=1e-6), case["name"]


def test_nan_outputs_score_zero():
    """A NaN forward degrades to AP 0, as in JAX."""
    outputs = {"pred_class": torch.full((2, 6, 2), float("nan")), "pred_boxes": torch.full((2, 6, 4), float("nan"))}
    targets = {"boxes": torch.tensor([[[0.1, 0.1, 0.4, 0.4]]] * 2), "labels": torch.zeros(2, 1, dtype=torch.int32),
               "valid": torch.ones(2, 1, dtype=torch.bool)}
    coco = CocoAveragePrecision(num_cls=1, max_dets_per_image=4)
    coco.update(outputs, targets)
    metric = MeanAveragePrecision(1)
    assert coco.compute() == 0.0 and metric.compute(metric.update(metric.init_state(), outputs, targets)) == 0.0
