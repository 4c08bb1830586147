"""The port's trainer builds its loaders as the JAX driver does
(``train/driver.py::_make_loaders``): at the default configuration
(letterbox eval on, synthetic data) both datasets cycle the aspect ratios
(1.0, 0.7, 1.4), the valid split draws from ``seed + 10_000`` and its loader
shuffles with ``seed + 1`` and letterboxes.

The first train and valid batches of the two packages' ``_make_loaders``
must agree: boxes, labels, valid and content extents exactly; images exactly
where no resize happens (square items at the canvas size) and within one grey
level where one does (the JAX package resizes with cv2 or its native C++
pool, the port with PyTorch's float bilinear, as tests/test_torch_data.py
records).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from object_detection_destr_tpu.config import Config as JaxConfig  # noqa: E402
from object_detection_destr_tpu.config import DataConfig as JaxDataConfig  # noqa: E402
from object_detection_destr_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from object_detection_destr_tpu.train.driver import _make_loaders as jax_make_loaders  # noqa: E402
from object_detection_destr_tpu_torch.config import Config, DataConfig, TrainConfig  # noqa: E402
from object_detection_destr_tpu_torch.train.driver import _make_loaders  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

TRAIN = dict(image_size=64, batch_size=4, seed=3)
DATA = dict(image_size=67, num_train_samples=8, num_valid_samples=8, augment_factor=2)
CANVAS = int(64 * 672 / 640)  # 67: square items need no resize


@pytest.mark.parametrize("letterbox_eval", [True, False])
def test_first_batches_match_jax(letterbox_eval):
    ours = _make_loaders(Config(train=TrainConfig(**TRAIN, letterbox_eval=letterbox_eval), data=DataConfig(**DATA)),
                         CANVAS, "destr")
    ref = jax_make_loaders(JaxConfig(train=JaxTrainConfig(**TRAIN, letterbox_eval=letterbox_eval),
                                     data=JaxDataConfig(**DATA)), CANVAS, "destr")
    assert [len(x) for x in ours] == [len(x) for x in ref] == [4, 2]
    aspects = (1.0, 0.7, 1.4) if letterbox_eval else (1.0,)
    for split, a, b in zip(("train", "valid"), ours, ref):
        assert a.dataset.aspect_ratios == b.dataset.aspect_ratios == aspects, split
        assert a.dataset.seed == b.dataset.seed and (a.seed, a.augment_factor) == (b.seed, b.augment_factor)
        assert a.letterbox == b.letterbox == (split == "valid" and letterbox_eval)
        order = b._epoch_order()  # before the prefetch thread can finish the epoch
        mine, theirs = next(iter(a)), next(iter(b))
        assert sorted(mine) == sorted(theirs), split
        for key in ("boxes", "labels", "valid", "content_hw"):
            if key in theirs:
                np.testing.assert_array_equal(mine[key], theirs[key], err_msg=f"{split} {key}")
        assert mine["images"].dtype == theirs["images"].dtype == np.uint8
        n = len(mine["images"])
        diff = np.abs(mine["images"].astype(int) - theirs["images"].astype(int)).reshape(n, -1).max(1)
        square = np.array([b.dataset[int(i) % len(b.dataset)][0].shape[:2] == (CANVAS, CANVAS)
                           for i in order[:n]])
        assert square.any() and (diff[square] == 0).all() and diff.max() <= 1, (split, diff, square)


def test_valid_split_seed():
    """The valid split's synthetic scenes are drawn from seed + 10_000."""
    cfg = Config(train=TrainConfig(**TRAIN), data=DataConfig(**DATA))
    train, valid = _make_loaders(cfg, CANVAS, "destr")
    assert (train.dataset.seed, valid.dataset.seed) == (3, 10_003)
    assert (train.seed, valid.seed) == (3, 4) and valid.augment_factor == 1
