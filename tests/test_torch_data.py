"""The port's training data path against the JAX package's: synthetic items
and loader batches (order, padding, images), and ``destr_train_transform`` at
the JAX transform's own crop and flip draws (drawn here with ``jax.random``
exactly as the JAX transform draws them, then handed to the port's
``crop_flip``).

Tolerances: items and batches at the canvas size are exact; a canvas resize
may differ by one grey level (cv2's fixed-point bilinear against PyTorch's
float one). The transformed images agree within 2e-4 of the normalized range
(the separable resampling is summed in another order), boxes within 1e-6,
validity exactly.
"""

import math

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


def test_synthetic_items_equal():
    kw = dict(image_size=48, num_samples=5, num_classes=1, seed=3)
    for split in ("train", "valid"):
        ours, ref = build_dataset("synthetic", split=split, **kw), jax_build_dataset("synthetic", split=split, **kw)
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            for a, b in zip(ours[i], ref[i]):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown dataset"):
        build_dataset("imagenet")


@pytest.mark.parametrize("image_size,canvas", [(48, 48), (40, 56)])
def test_loader_batches_equal(image_size, canvas):
    kw = dict(image_size=image_size, num_samples=6, seed=1)
    lk = dict(batch_size=2, canvas_size=canvas, max_targets=10, augment_factor=2, shuffle=True, seed=4)
    ours = DetectionLoader(build_dataset("synthetic", **kw), **lk)
    ref = JaxLoader(jax_build_dataset("synthetic", **kw), **lk)
    assert len(ours) == len(ref) == 6
    for _ in range(2):  # two epochs: the shuffle depends on (seed, epoch)
        for a, b in zip(ours, ref):
            for key in ("boxes", "labels", "valid"):
                np.testing.assert_array_equal(a[key], b[key])
            diff = np.abs(a["images"].astype(int) - b["images"].astype(int))
            assert diff.max() <= (0 if image_size == canvas else 1)
    assert ours.epoch == ref.epoch == 2


def _jax_draws(key, b, scale_range=(0.08, 1.0), ratio_range=(3.0 / 4.0, 4.0 / 3.0)):
    """The draws destr_train_transform makes from ``key`` (transforms.py:119-144)."""
    out = {k: [] for k in ("area", "log_r", "uy", "ux", "flip")}
    for k in jax.random.split(key, b):
        k_area, k_ratio, k_y, k_x, k_flip = jax.random.split(k, 5)
        out["area"].append(jax.random.uniform(k_area, minval=scale_range[0], maxval=scale_range[1]))
        out["log_r"].append(jax.random.uniform(k_ratio, minval=math.log(ratio_range[0]),
                                               maxval=math.log(ratio_range[1])))
        out["uy"].append(jax.random.uniform(k_y, minval=0.0, maxval=1.0))
        out["ux"].append(jax.random.uniform(k_x, minval=0.0, maxval=1.0))
        out["flip"].append(jax.random.bernoulli(k_flip))
    return {k: torch.from_numpy(np.array(jnp.stack(v))) for k, v in out.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_transform_matches_jax_at_the_same_draws(seed):
    lk = dict(batch_size=4, canvas_size=50, max_targets=10, shuffle=False)
    raw = next(iter(JaxLoader(jax_build_dataset("synthetic", image_size=50, num_samples=4, seed=seed), **lk)))
    key = jax.random.PRNGKey(seed)
    ref = jax_transform(*(jnp.asarray(raw[k]) for k in ("images", "boxes", "labels", "valid")), key, out_size=32)
    d = _jax_draws(key, 4)
    ours = crop_flip(*(torch.from_numpy(raw[k]) for k in ("images", "boxes", "labels", "valid")),
                     d["area"], d["log_r"], d["uy"], d["ux"], d["flip"], out_size=32)
    img_ref = np.asarray(ref["images"])
    assert np.abs(ours["images"].numpy() - img_ref).max() <= 2e-4 * np.abs(img_ref).max()
    np.testing.assert_allclose(ours["boxes"].numpy(), np.asarray(ref["boxes"]), atol=1e-6)
    np.testing.assert_array_equal(ours["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(ours["labels"].numpy(), raw["labels"])


def test_train_transform_draws_from_its_generator():
    raw = next(iter(DetectionLoader(build_dataset("synthetic", image_size=40, num_samples=2), batch_size=2,
                                    canvas_size=40, max_targets=8)))
    args = [torch.from_numpy(raw[k]) for k in ("images", "boxes", "labels", "valid")]
    a = destr_train_transform(*args, torch.Generator().manual_seed(5), out_size=24)
    b = destr_train_transform(*args, torch.Generator().manual_seed(5), out_size=24)
    c = destr_train_transform(*args, torch.Generator().manual_seed(6), out_size=24)
    assert torch.equal(a["images"], b["images"]) and not torch.equal(a["images"], c["images"])
    assert a["images"].shape == (2, 24, 24, 3) and a["images"].dtype == torch.float32
