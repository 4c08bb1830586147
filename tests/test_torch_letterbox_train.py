"""Letterbox training's crop (``crop_flip`` with ``content_hw``) against the
JAX package's ``destr_train_transform(..., content_hw)`` at the JAX
transform's own draws (drawn here with ``jax.random`` as it draws them,
``tests/test_torch_data.py::_jax_draws``), on letterboxed batches of both
loaders (aspect ratios 1.0, 0.7, 1.4: content in one or the other axis).

Tolerances: ``pixel_valid`` and ``valid`` equal; boxes within 1e-6; the
normalized images (values up to about 2.6) within 1e-5 absolute plus 1e-5
relative: the separable resampling sums in another order than JAX's one
einsum, up to 1.4e-5 apart at values near 1.7.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.data.datasets import build_dataset as jax_build_dataset  # noqa: E402
from object_detection_destr_tpu.data.loader import DetectionLoader as JaxLoader  # noqa: E402
from object_detection_destr_tpu.data.transforms import destr_train_transform as jax_transform  # noqa: E402
from object_detection_destr_tpu_torch.data import DetectionLoader, build_dataset  # noqa: E402
from object_detection_destr_tpu_torch.data.transforms import crop_flip, destr_train_transform  # noqa: E402
from test_torch_data import _jax_draws  # noqa: E402

KEYS = ("images", "boxes", "labels", "valid")


@pytest.mark.parametrize("seed", [0, 1])
def test_letterbox_crop_matches_jax_at_the_same_draws(seed):
    kw = dict(image_size=40, num_samples=6, seed=seed, aspect_ratios=(1.0, 0.7, 1.4))
    lk = dict(batch_size=6, canvas_size=48, max_targets=10, shuffle=False, letterbox=True, prefetch=0)
    raw = next(iter(JaxLoader(jax_build_dataset("synthetic", **kw), **lk)))
    assert (raw["content_hw"] < 1.0).any()
    key = jax.random.PRNGKey(seed + 10)
    ref = jax_transform(*(jnp.asarray(raw[k]) for k in KEYS), key, jnp.asarray(raw["content_hw"]), out_size=32)
    d = _jax_draws(key, 6)
    ours = crop_flip(*(torch.from_numpy(raw[k]) for k in KEYS), d["area"], d["log_r"], d["uy"], d["ux"],
                     d["flip"], out_size=32, content_hw=torch.from_numpy(raw["content_hw"]))
    np.testing.assert_array_equal(ours["pixel_valid"].numpy(), np.asarray(ref["pixel_valid"]))
    assert not ours["pixel_valid"].all()  # some crops reach into the padding
    np.testing.assert_allclose(ours["images"].numpy(), np.asarray(ref["images"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours["boxes"].numpy(), np.asarray(ref["boxes"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours["valid"].numpy(), np.asarray(ref["valid"]))


def test_letterbox_batches_and_transform():
    """The port's letterbox loader gives the JAX loader's targets and content
    extents, and its train transform adds ``pixel_valid`` only with them."""
    kw = dict(image_size=40, num_samples=3, seed=2, aspect_ratios=(1.0, 0.7, 1.4))
    lk = dict(batch_size=3, canvas_size=48, max_targets=10, shuffle=False, letterbox=True, prefetch=0)
    ours = next(iter(DetectionLoader(build_dataset("synthetic", **kw), **lk)))
    ref = next(iter(JaxLoader(jax_build_dataset("synthetic", **kw), **lk)))
    for k in ("boxes", "labels", "valid", "content_hw"):
        np.testing.assert_array_equal(ours[k], ref[k])
    args = [torch.from_numpy(ours[k]) for k in KEYS]
    boxed = destr_train_transform(*args, torch.Generator().manual_seed(1), torch.from_numpy(ours["content_hw"]),
                                  out_size=24)
    plain = destr_train_transform(*args, torch.Generator().manual_seed(1), out_size=24)
    assert boxed["pixel_valid"].shape == (3, 24, 24) and "pixel_valid" not in plain
