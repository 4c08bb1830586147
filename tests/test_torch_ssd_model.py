"""The port's SSD300 and its geometry against the JAX package's.

* ``SSD`` forward at 300 px (the only size where the extra-block pyramid
  closes, so the only one that exercises flax's asymmetric SAME padding of
  the stride-2 convs at 10 -> 5), B=1, eval mode, one set of random flax
  variables (BatchNorm statistics away from identity) carried over by
  ``models/convert.py``. Tolerance, per head output: float32 1e-4 of the JAX
  output's largest magnitude (convolution summation orders differ); bfloat16
  3e-2 (both sides round every trunk and extra-block output to bfloat16 at
  the same places, in different summation orders, and the float32 heads
  read those rounded features).
* ``param_labels``: the port's labels equal the JAX package's leaf for
  leaf; the VGG trunk is frozen in both (its names match no trainable
  backbone prefix).
* ``make_grid``, ``default_boxes``, ``flat_anchors``, ``xywh_to_xyxy`` and
  ``clip_boxes_to_window``: equal to float32 rounding (1e-6 absolute).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from object_detection_destr_tpu.config import SSDConfig as JaxSSDConfig  # noqa: E402
from object_detection_destr_tpu.geometry import boxes as jboxes  # noqa: E402
from object_detection_destr_tpu.models.ssd.model import build_ssd as jax_build_ssd  # noqa: E402
from object_detection_destr_tpu.train.optim import param_labels as jax_param_labels  # noqa: E402
from object_detection_destr_tpu.train.steps import flat_anchors as jax_flat_anchors  # noqa: E402
from object_detection_destr_tpu_torch.config import SSDConfig  # noqa: E402
from object_detection_destr_tpu_torch.geometry import boxes as tboxes  # noqa: E402
from object_detection_destr_tpu_torch.models.convert import load_flax_variables  # noqa: E402
from object_detection_destr_tpu_torch.models.ssd import build_ssd  # noqa: E402
from object_detection_destr_tpu_torch.train.optim import param_labels  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import flat_anchors  # noqa: E402

from test_torch_modules import _close, _random_variables  # noqa: E402

SIZE = 300


@pytest.fixture(scope="module")
def variables():
    model = jax_build_ssd(JaxSSDConfig())
    return _random_variables(model, np.random.default_rng(3), jnp.zeros((1, SIZE, SIZE, 3)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_forward_matches_jax_at_300(variables, dtype, tol):
    images = np.random.default_rng(4).normal(size=(1, SIZE, SIZE, 3)).astype(np.float32)
    ref = jax_build_ssd(JaxSSDConfig(compute_dtype=dtype)).apply(variables, jnp.asarray(images), train=False)
    model = load_flax_variables(build_ssd(SSDConfig(compute_dtype=dtype), "cpu"), variables)
    with torch.no_grad():
        ours = model(torch.from_numpy(images))
    for key in ("boxes", "conf"):
        assert len(ours[key]) == len(ref[key]) == 6
        for i, (o, r) in enumerate(zip(ours[key], ref[key])):
            assert o.dtype == torch.float32
            _close(o.numpy(), np.asarray(r), f"{dtype} {key}[{i}]", tol)


def test_param_labels_match_jax(variables):
    ref = traverse_util.flatten_dict(jax_param_labels(variables["params"]))
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    ref = {".".join(path[:-1] + (leaf[path[-1]],)): label for path, label in ref.items()}
    ours = param_labels(build_ssd(SSDConfig(), "cpu"))
    assert ours == ref
    frozen = [name for name, label in ours.items() if label == "frozen"]
    assert len(frozen) == 20 and all(name.startswith("backbone.conv") for name in frozen)
    assert "backbone" not in ours.values()


def test_default_boxes_and_anchors_match_jax():
    cfg = SSDConfig()
    ours = tboxes.default_boxes(cfg.feature_shapes, cfg.scales, cfg.aspect_ratios)
    ref = jboxes.default_boxes(cfg.feature_shapes, cfg.scales, cfg.aspect_ratios)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    anchors = flat_anchors(cfg)
    assert anchors.shape == (8432, 4)
    np.testing.assert_allclose(anchors.numpy(), np.asarray(jax_flat_anchors(JaxSSDConfig())), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tboxes.make_grid(3, 5, bias=0.25, norm=False).numpy(),
                               np.asarray(jboxes.make_grid(3, 5, bias=0.25, norm=False)), rtol=0, atol=1e-6)


def test_box_helpers_match_jax():
    rng = np.random.default_rng(6)
    xywh = rng.uniform(0.0, 0.7, size=(5, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(tboxes.xywh_to_xyxy(torch.from_numpy(xywh)).numpy(),
                               np.asarray(jboxes.xywh_to_xyxy(jnp.asarray(xywh))), rtol=0, atol=1e-6)
    pixels = np.concatenate([rng.uniform(-20, 320, size=(9, 2)), rng.uniform(1, 200, size=(9, 2))],
                            -1).astype(np.float32)
    window, origin = (30.0, 40.0, 250.0, 210.0), (240.0, 300.0)
    np.testing.assert_allclose(
        tboxes.clip_boxes_to_window(torch.from_numpy(pixels), window, origin).numpy(),
        np.asarray(jboxes.clip_boxes_to_window(jnp.asarray(pixels), window, origin)), rtol=0, atol=1e-4)
