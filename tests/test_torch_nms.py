"""The port's NMS and SSD post-processing against the JAX package's.

``nms_triangular`` and ``nms_greedy`` on random boxes whose scores are
quantized to 0.05 steps, so many are exactly equal (both sort stably:
equal scores keep ascending index order); the port runs the images as one
batch, JAX image by image. ``ssd_predict`` on two-scale outputs whose
logits are quantized, so top-k ranks exactly tied scores. Orders, keep
masks, indices and labels equal; boxes and scores within 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.infer.predict import ssd_predict as jax_ssd_predict  # noqa: E402
from object_detection_destr_tpu.ops.nms import (  # noqa: E402
    nms_greedy as jax_nms_greedy,
    nms_triangular as jax_nms_triangular,
)
from object_detection_destr_tpu_torch.infer.predict import ssd_predict  # noqa: E402
from object_detection_destr_tpu_torch.ops.nms import nms_greedy, nms_triangular  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401


def _boxes(rng, b, s):
    xy = rng.uniform(0.0, 0.7, size=(b, s, 2))
    wh = rng.uniform(0.05, 0.3, size=(b, s, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (np.round(rng.uniform(0.0, 1.0, size=(b, s)) * 20) / 20).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("name", ["triangular", "greedy"])
@pytest.mark.parametrize("iou_thresh,score_thresh", [(0.5, 0.5), (0.3, 0.0)])
def test_nms_matches_jax(name, iou_thresh, score_thresh):
    ours_fn, ref_fn = {"triangular": (nms_triangular, jax_nms_triangular),
                       "greedy": (nms_greedy, jax_nms_greedy)}[name]
    boxes, scores = _boxes(np.random.default_rng(21), 3, 60)
    assert len(np.unique(scores[0])) < 30  # exact ties
    order, keep = ours_fn(torch.from_numpy(boxes), torch.from_numpy(scores), iou_thresh=iou_thresh,
                          score_thresh=score_thresh)
    for i in range(boxes.shape[0]):
        ref_order, ref_keep = ref_fn(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), iou_thresh=iou_thresh,
                                     score_thresh=score_thresh)
        assert np.array_equal(order[i].numpy(), np.asarray(ref_order))
        assert np.array_equal(keep[i].numpy(), np.asarray(ref_keep))
    assert keep.any() and not keep.all()


def _ssd_outputs(rng, b=2, num_cls=3):
    grids = [(5, 4), (3, 6)]  # (grid, anchors) of two scales
    total = sum(g * g * a for g, a in grids)
    outputs = {
        "boxes": [rng.normal(0, 0.2, size=(b, g, g, a, 4)).astype(np.float32) for g, a in grids],
        # logits on a 0.5 grid: equal probabilities recur, so top-k ranks exact ties
        "conf": [np.round(rng.normal(0, 1.5, size=(b, g, g, a, num_cls + 1)) * 2).astype(np.float32) / 2
                 for g, a in grids],
    }
    anchors = np.stack([rng.uniform(0.2, 0.8, total), rng.uniform(0.2, 0.8, total),
                        rng.uniform(0.1, 0.4, total), rng.uniform(0.1, 0.4, total)], -1).astype(np.float32)
    return outputs, anchors


@pytest.mark.parametrize("max_dets,score_thresh", [(40, 0.5), (200, 0.2)])
def test_ssd_predict_matches_jax(max_dets, score_thresh):
    outputs, anchors = _ssd_outputs(np.random.default_rng(22))
    ref = jax_ssd_predict({k: [jnp.asarray(t) for t in v] for k, v in outputs.items()}, jnp.asarray(anchors),
                          score_thresh=score_thresh, max_dets=max_dets)
    ours = ssd_predict({k: [torch.from_numpy(t) for t in v] for k, v in outputs.items()},
                       torch.from_numpy(anchors), score_thresh=score_thresh, max_dets=max_dets)
    assert ours["scores"].shape == np.asarray(ref["scores"]).shape == (2, min(max_dets, 154))
    assert len(np.unique(np.asarray(ref["scores"])[0])) < ours["scores"].shape[1]  # exact ties ranked
    np.testing.assert_allclose(ours["scores"].numpy(), np.asarray(ref["scores"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours["boxes"].numpy(), np.asarray(ref["boxes"]), rtol=0, atol=1e-6)
    assert np.array_equal(ours["labels"].numpy(), np.asarray(ref["labels"]))
    assert np.array_equal(ours["valid"].numpy(), np.asarray(ref["valid"]))
    assert ours["valid"].any() and not ours["valid"].all()
