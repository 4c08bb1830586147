"""The port's SSD transforms against the JAX package's, on loader batches of
the 20-class synthetic set (48 px canvases, 32 px out).

``ssd_train_transform`` is fed the JAX transform's own draws (a mode, 8
candidate crops and offsets, a flip per image, drawn here with
``jax.random`` exactly as the JAX transform draws them) through the port's
``ssd_patch_flip``; ``ssd_eval_transform`` needs no draws. Tolerances as
``tests/test_torch_data.py``'s: images within 2e-4 of the normalized range
(the separable resampling is summed in another order), cxcyhw boxes within
1e-6, validity and labels exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.data.transforms import (  # noqa: E402
    ssd_eval_transform as jax_eval,
    ssd_train_transform as jax_train,
)
from object_detection_destr_tpu_torch.data import DetectionLoader, build_dataset  # noqa: E402
from object_detection_destr_tpu_torch.data.transforms import (  # noqa: E402
    ssd_eval_transform,
    ssd_patch_flip,
    ssd_train_transform,
)
from torch_threads import one_torch_thread  # noqa: E402, F401

KEYS = ("images", "boxes", "labels", "valid")


def _raw(seed, b=8):
    ds = build_dataset("synthetic", image_size=48, num_samples=b, num_classes=20, seed=seed)
    return next(iter(DetectionLoader(ds, batch_size=b, canvas_size=48, max_targets=10, seed=seed)))


def _jax_draws(key, b, k=8):
    """The draws of ``ssd_train_transform`` (transforms.py:273-285) per image."""
    mode, dims, pos, flip = [], [], [], []
    for one in jax.random.split(key, b):
        k_mode, k_dims, k_pos, k_flip = jax.random.split(one, 4)
        mode.append(int(jax.random.randint(k_mode, (), 0, 7)))
        dims.append(np.asarray(jax.random.uniform(k_dims, (k, 2), minval=0.3, maxval=1.0)))
        pos.append(np.asarray(jax.random.uniform(k_pos, (k, 2))))
        flip.append(bool(jax.random.bernoulli(k_flip)))
    return (torch.tensor(mode), torch.from_numpy(np.stack(dims)), torch.from_numpy(np.stack(pos)),
            torch.tensor(flip))


def _close(ours, ref):
    img_ref = np.asarray(ref["images"])
    assert np.abs(ours["images"].numpy() - img_ref).max() <= 2e-4 * np.abs(img_ref).max()
    np.testing.assert_allclose(ours["boxes"].numpy(), np.asarray(ref["boxes"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(ours["labels"].numpy(), np.asarray(ref["labels"]))


@pytest.mark.parametrize("seed", [1, 5])
def test_train_transform_matches_jax_at_its_draws(seed):
    raw = _raw(seed)
    key = jax.random.PRNGKey(seed)
    ref = jax_train(*(jnp.asarray(raw[k]) for k in KEYS), key, out_size=32)
    mode, dims, pos, flip = _jax_draws(key, 8)
    assert (mode == 0).any() and (mode > 0).any() and flip.any() and not flip.all()
    ours = ssd_patch_flip(*(torch.from_numpy(raw[k]) for k in KEYS), mode, dims, pos, flip, out_size=32)
    _close(ours, ref)
    assert not np.array_equal(ours["valid"].numpy(), raw["valid"])  # some crop dropped a box


def test_eval_transform_matches_jax():
    raw = _raw(2, b=4)
    _close(ssd_eval_transform(*(torch.from_numpy(raw[k]) for k in KEYS), out_size=32),
           jax_eval(*(jnp.asarray(raw[k]) for k in KEYS), out_size=32))


def test_train_transform_draws_from_its_generator():
    args = [torch.from_numpy(_raw(3, b=2)[k]) for k in KEYS]
    a = ssd_train_transform(*args, torch.Generator().manual_seed(5), out_size=24)
    b = ssd_train_transform(*args, torch.Generator().manual_seed(5), out_size=24)
    c = ssd_train_transform(*args, torch.Generator().manual_seed(6), out_size=24)
    assert torch.equal(a["images"], b["images"]) and not torch.equal(a["images"], c["images"])
    assert a["images"].shape == (2, 24, 24, 3) and a["boxes"].shape == (2, 10, 4)
