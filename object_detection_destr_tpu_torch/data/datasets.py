"""Dataset readers (port of ``object_detection_destr_tpu/data/datasets.py``).

Each dataset yields ``(image_uint8_HWC, boxes_xyxy_normalized, labels)`` for
one index. This slice ports the synthetic scenes the production recipe trains
on; the WIDER FACE, VOC and COCO readers come with a later slice and
:func:`build_dataset` raises for them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticDetection", "build_dataset"]


class SyntheticDetection:
    """Deterministic random scenes: bright rectangles on dark noise.

    Learnable by construction (objects are visually distinct), so a few
    hundred steps of overfit drives loss down and mAP up — the integration
    signal the reference repo never had.
    """

    def __init__(
        self,
        num_samples: int = 64,
        image_size: int = 256,
        max_boxes: int = 8,
        num_classes: int = 1,
        seed: int = 0,
        aspect_ratios: tuple = (1.0,),
    ):
        self.num_samples = num_samples
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.num_classes = num_classes
        self.seed = seed
        # w/h ratios cycled per index; non-1 values yield non-square images
        # (real datasets are non-square — exercises the letterbox path)
        self.aspect_ratios = aspect_ratios

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        ar = self.aspect_ratios[idx % len(self.aspect_ratios)]
        s = self.image_size
        sw = max(int(round(s * ar)), 8)
        image = rng.integers(0, 40, size=(s, sw, 3), dtype=np.uint8)
        n = int(rng.integers(1, self.max_boxes + 1))
        boxes, labels = [], []
        for _ in range(n):
            w = rng.uniform(0.1, 0.4)
            h = rng.uniform(0.1, 0.4)
            x1 = rng.uniform(0.0, 1.0 - w)
            y1 = rng.uniform(0.0, 1.0 - h)
            cls = int(rng.integers(0, self.num_classes))
            color = np.zeros(3, np.uint8)
            color[cls % 3] = 255 - 40 * (cls // 3)
            xi1, yi1 = int(x1 * sw), int(y1 * s)
            xi2, yi2 = int((x1 + w) * sw), int((y1 + h) * s)
            image[yi1:yi2, xi1:xi2] = color
            boxes.append([x1, y1, x1 + w, y1 + h])
            labels.append(cls)
        return image, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


def build_dataset(
    name: str,
    root: str = "dataset",
    split: str = "train",
    *,
    image_size: int = 256,
    num_samples: int = 64,
    num_classes: int = 1,
    max_items_per_img: int = 300,
    seed: int = 0,
    aspect_ratios: tuple = (1.0,),
):
    """Dataset factory keyed by the config's ``data.dataset`` string
    (datasets.py:335-366)."""
    if name == "synthetic":
        return SyntheticDetection(
            num_samples=num_samples,
            image_size=image_size,
            num_classes=num_classes,
            seed=seed + (0 if split == "train" else 10_000),
            aspect_ratios=aspect_ratios,
        )
    if name in ("widerface", "voc", "coco"):
        raise NotImplementedError(f"the {name} reader is not ported yet; use dataset='synthetic'")
    raise ValueError(f"unknown dataset {name!r}")
