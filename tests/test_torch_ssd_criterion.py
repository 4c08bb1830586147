"""The port's SSD matching and criterion against the JAX package's, on the
tiny two-scale problems of ``tests/test_criterion.py::_tiny_ssd_problem``.

* ``decode_ssd_boxes``: 1e-6 absolute; ``ssd_match``: the match matrix and
  the positives equal.
* ``ssd_criterion``, mining "reference" and "paper": the three losses
  within 1e-5 relative, and the gradients of the loss with respect to every
  head output within 1e-5 of the JAX gradient's largest magnitude (float32
  on both sides; the sums run in other orders).
* With many exactly equal background log-probabilities (quantized logits),
  the losses still agree within 1e-5: the mined sum does not depend on how
  a sort orders equal values (its gradient, which picks among them, may).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.geometry.boxes import cxcyhw_to_xyxy as jax_cxcyhw_to_xyxy  # noqa: E402
from object_detection_destr_tpu.losses.criterion import ssd_criterion as jax_ssd_criterion  # noqa: E402
from object_detection_destr_tpu.losses.matcher import (  # noqa: E402
    decode_ssd_boxes as jax_decode,
    ssd_match as jax_ssd_match,
)
from object_detection_destr_tpu_torch.geometry.boxes import cxcyhw_to_xyxy  # noqa: E402
from object_detection_destr_tpu_torch.losses.criterion import _flatten_scales, ssd_criterion  # noqa: E402
from object_detection_destr_tpu_torch.losses.matcher import decode_ssd_boxes, ssd_match  # noqa: E402

from test_criterion import _tiny_ssd_problem  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

TOL = 1e-5


def _problem(seed, quantize=False):
    outputs, targets, anchors = _tiny_ssd_problem(np.random.default_rng(seed), b=2, t=3, num_cls=4)
    outputs = {k: [np.array(t) for t in v] for k, v in outputs.items()}
    if quantize:  # logits in {0, 1}: many rows share their background log-probability
        outputs["conf"] = [(t > 0.3).astype(np.float32) for t in outputs["conf"]]
    return outputs, {k: np.asarray(v) for k, v in targets.items()}, np.asarray(anchors)


def _torch(outputs, targets, anchors, grad=False):
    outs = {k: [torch.tensor(t, requires_grad=grad) for t in v] for k, v in outputs.items()}
    return outs, {k: torch.from_numpy(np.array(v)) for k, v in targets.items()}, torch.from_numpy(np.array(anchors))


def test_decode_and_match_match_jax():
    outputs, targets, anchors = _problem(11)
    outs, tgts, anc = _torch(outputs, targets, anchors)
    flat = np.concatenate([t.reshape(t.shape[0], -1, 4) for t in outputs["boxes"]], 1)
    ref = jax_decode(jnp.asarray(flat), jnp.asarray(anchors))
    ours = decode_ssd_boxes(_flatten_scales(outs["boxes"]), anc)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    gt_j = jax_cxcyhw_to_xyxy(jnp.asarray(targets["boxes"]))
    match_j, pos_j = jax_ssd_match(jax_cxcyhw_to_xyxy(ref), gt_j, jnp.asarray(targets["valid"]))
    match, pos = ssd_match(cxcyhw_to_xyxy(ours), cxcyhw_to_xyxy(tgts["boxes"]), tgts["valid"])
    assert np.array_equal(match.numpy(), np.asarray(match_j)) and np.array_equal(pos.numpy(), np.asarray(pos_j))
    assert match.any() and not match.all()


@pytest.mark.parametrize("mining", ["reference", "paper"])
@pytest.mark.parametrize("seed", [11, 12])
def test_criterion_and_gradients_match_jax(mining, seed):
    outputs, targets, anchors = _problem(seed)
    jouts = {k: [jnp.asarray(t) for t in v] for k, v in outputs.items()}
    jtgts = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(outs):
        losses = jax_ssd_criterion(outs, jtgts, jnp.asarray(anchors), loss_coef=0.5, mining=mining)
        return losses["loss"], losses

    (_, ref), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(jouts)
    outs, tgts, anc = _torch(outputs, targets, anchors, grad=True)
    ours = ssd_criterion(outs, tgts, anc, loss_coef=0.5, mining=mining)
    ours["loss"].backward()
    for k in ("loss", "class", "local"):
        np.testing.assert_allclose(float(ours[k].detach()), float(ref[k]), rtol=TOL, err_msg=k)
    for key in ("boxes", "conf"):
        for i, (o, r) in enumerate(zip(outs[key], ref_grads[key])):
            r = np.asarray(r)
            assert np.abs(r).max() > 0, (key, i)
            err = np.abs(o.grad.numpy() - r).max() / np.abs(r).max()
            assert err <= TOL, f"{mining} grad {key}[{i}]: {err:.2e}"


@pytest.mark.parametrize("mining", ["reference", "paper"])
def test_mined_sum_ignores_tie_order(mining):
    outputs, targets, anchors = _problem(13, quantize=True)
    ref = jax_ssd_criterion({k: [jnp.asarray(t) for t in v] for k, v in outputs.items()},
                            {k: jnp.asarray(v) for k, v in targets.items()}, jnp.asarray(anchors), mining=mining)
    ours = ssd_criterion(*_torch(outputs, targets, anchors), mining=mining)
    for k in ("loss", "class", "local"):
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=TOL, err_msg=k)
