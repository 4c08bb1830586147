"""``set_criterion`` of the port against the JAX package's: loss values and
their gradients with respect to the predicted logits and boxes, with every
option (class_norm queries|boxes, ciou_mode elementwise|reference,
background_class, precomputed rows, rows past N), float32.

Both sides take the same rows: those of the JAX fused matcher
(``hungarian_match_pallas``, interpret mode), or hand-made ones. Tolerance
1e-5 relative to each quantity's largest value (float32, summation order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.losses.criterion import set_criterion as jax_set_criterion  # noqa: E402
from object_detection_destr_tpu.ops.pallas.auction import hungarian_match_pallas  # noqa: E402
from object_detection_destr_tpu_torch.losses.criterion import set_criterion  # noqa: E402
from object_detection_destr_tpu_torch.ops.cuda.auction import hungarian_match_fused  # noqa: E402

TOL = 1e-5


def _batch(b=3, n=12, t=6, c=2, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, n, c)).astype(np.float32)
    boxes = np.stack([rng.uniform(0.2, 0.8, (b, n)), rng.uniform(0.2, 0.8, (b, n)),
                      rng.uniform(0.05, 0.5, (b, n)), rng.uniform(0.05, 0.5, (b, n))], -1).astype(np.float32)
    xy = rng.uniform(0.0, 0.6, (b, t, 2))
    wh = rng.uniform(0.05, 0.4, (b, t, 2))
    tb = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, c, (b, t)).astype(np.int32)
    valid = rng.uniform(size=(b, t)) < 0.7
    valid[-1] = False  # an image with no targets
    return logits, boxes, tb, labels, valid


def _jax_losses(logits, boxes, targets, rows, **opts):
    def f(lg, bx):
        out = jax_set_criterion({"pred_class": lg, "pred_boxes": bx}, targets, rows=rows, **opts)
        return out["class"] + 2.5 * out["bbox"] + out["ciou"], out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(logits), jnp.asarray(boxes))
    return {k: float(v) for k, v in out.items()}, [np.asarray(g) for g in grads]


def _port_losses(logits, boxes, targets, rows, **opts):
    lg = torch.from_numpy(logits).requires_grad_(True)
    bx = torch.from_numpy(boxes).requires_grad_(True)
    out = set_criterion({"pred_class": lg, "pred_boxes": bx}, targets, rows=rows, **opts)
    (out["class"] + 2.5 * out["bbox"] + out["ciou"]).backward()
    return {k: float(v.detach()) for k, v in out.items()}, [lg.grad.numpy(), bx.grad.numpy()]


OPTIONS = {
    "queries_elementwise": dict(class_norm="queries", ciou_mode="elementwise"),
    "boxes_elementwise": dict(class_norm="boxes", ciou_mode="elementwise"),
    "boxes_reference_ciou": dict(class_norm="boxes", ciou_mode="reference"),
    "queries_reference_ciou_bg0": dict(class_norm="queries", ciou_mode="reference", background_class=0),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_set_criterion_matches_jax(name):
    logits, boxes, tb, labels, valid = _batch(seed=sorted(OPTIONS).index(name))
    rows = np.array(hungarian_match_pallas(*map(jnp.asarray, (logits, boxes, tb, labels, valid))))
    jt = {"boxes": jnp.asarray(tb), "labels": jnp.asarray(labels), "valid": jnp.asarray(valid)}
    tt = {"boxes": torch.from_numpy(tb), "labels": torch.from_numpy(labels), "valid": torch.from_numpy(valid)}
    ref, ref_grads = _jax_losses(logits, boxes, jt, jnp.asarray(rows), **OPTIONS[name])
    ours, grads = _port_losses(logits, boxes, tt, torch.from_numpy(rows).long(), **OPTIONS[name])
    for k in ("class", "bbox", "ciou"):
        assert abs(ours[k] - ref[k]) <= TOL * max(abs(ref[k]), 1e-3), (k, ours[k], ref[k])
    for g, r in zip(grads, ref_grads):
        assert np.abs(g - r).max() <= TOL * max(np.abs(r).max(), 1e-6)


def test_rows_past_n_and_matcher_default():
    """A target parked on a row past N drops out of every loss, as in the
    JAX package; with rows=None the port matches through its fused matcher."""
    logits, boxes, tb, labels, valid = _batch(b=2, n=5, t=7, seed=9)
    valid[:] = True
    rows = np.stack([np.array([6, 0, 1, 2, 3, 4, 5]), np.array([1, 0, 5, 2, 6, 3, 4])]).astype(np.int32)
    jt = {"boxes": jnp.asarray(tb), "labels": jnp.asarray(labels), "valid": jnp.asarray(valid)}
    tt = {"boxes": torch.from_numpy(tb), "labels": torch.from_numpy(labels), "valid": torch.from_numpy(valid)}
    ref, ref_grads = _jax_losses(logits, boxes, jt, jnp.asarray(rows), class_norm="boxes")
    ours, grads = _port_losses(logits, boxes, tt, torch.from_numpy(rows).long(), class_norm="boxes")
    for k in ("class", "bbox", "ciou"):
        assert abs(ours[k] - ref[k]) <= TOL * max(abs(ref[k]), 1e-3), k
    for g, r in zip(grads, ref_grads):
        assert np.abs(g - r).max() <= TOL * max(np.abs(r).max(), 1e-6)

    logits, boxes, tb, labels, valid = _batch(seed=4)
    tt = {"boxes": torch.from_numpy(tb), "labels": torch.from_numpy(labels), "valid": torch.from_numpy(valid)}
    outs = {"pred_class": torch.from_numpy(logits), "pred_boxes": torch.from_numpy(boxes)}
    rows = hungarian_match_fused(outs["pred_class"], outs["pred_boxes"], tt["boxes"], tt["labels"], tt["valid"])
    a = set_criterion(outs, tt)
    b = set_criterion(outs, tt, rows=rows)
    assert all(torch.equal(a[k], b[k]) for k in a)
