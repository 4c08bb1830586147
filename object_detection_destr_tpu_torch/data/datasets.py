"""Dataset readers (port of ``object_detection_destr_tpu/data/datasets.py``).

Each dataset yields ``(image_uint8_HWC, boxes_xyxy_normalized, labels)`` for
one index; canvas resize, target padding and batching live in
:mod:`.loader`, augmentation on the device in :mod:`.transforms`. The readers
take the formats of the reference (its torchvision datasets,
src/dataset/dataset.py:12-140) and COCO:

* WIDER FACE: ``wider_face_split/wider_face_{split}_bbx_gt.txt`` lists, a
  0-count entry still followed by one dummy row; zero-size boxes dropped,
  boxes sorted by area, largest first, and capped at ``max_items_per_img``;
  one class, 0 (dataset.py:39-64).
* Pascal VOC XML with the reference's 20-class order, not alphabetical
  (:data:`VOC_CLASSES`, dataset.py:76-97); split "valid" reads the image set
  "trainval", the reference's quirk (REFCOMPAT); ``keep_difficult``.
* COCO instances JSON (2017 layout), crowd annotations skipped, category ids
  mapped to 0..C-1 in id order.
* Synthetic boxes-on-noise scenes for tests and the recipe's runs.

``raw_item`` gives a JPEG's bytes with its annotations normalized by the
size its header (WIDER), its XML (VOC) or the JSON (COCO) states, so that
the loader's native decode pool (``runtime/native.py``) decodes and resizes
without a Python-side decode; a non-JPEG file raises ``AttributeError``.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET

import numpy as np

__all__ = [
    "CocoDetection",
    "SyntheticDetection",
    "VOC_CLASSES",
    "VocDetection",
    "WiderFaceDetection",
    "build_dataset",
]

# The reference's class -> index map, NOT alphabetical (dataset.py:76-97):
# person = 0, bird = 1, ..., so labels, checkpoints and per-class metrics
# carry across
VOC_CLASSES = (
    "person", "bird", "cat", "cow", "dog", "horse", "sheep", "aeroplane",
    "bicycle", "boat", "bus", "car", "motorbike", "train", "bottle", "chair",
    "diningtable", "pottedplant", "sofa", "tvmonitor",
)


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _jpeg_size(data: bytes) -> tuple[int, int]:
    """(height, width) from the first SOF marker of a JPEG stream, without
    decoding a pixel."""
    i, n = 2, len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:  # standalone markers
            i += 2
            continue
        length = (data[i + 2] << 8) | data[i + 3]
        # SOF0..SOF15 but DHT (C4), JPG (C8) and DAC (CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h = (data[i + 5] << 8) | data[i + 6]
            w = (data[i + 7] << 8) | data[i + 8]
            return h, w
        i += 2 + length
    raise ValueError("no SOF marker found in JPEG stream")


def _read_jpeg_bytes(path: str) -> bytes:
    if not path.lower().endswith((".jpg", ".jpeg")):
        raise AttributeError("raw_item supports JPEG files only")
    with open(path, "rb") as f:
        return f.read()


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


class WiderFaceDetection:
    """WIDER FACE from the official annotation list files (datasets.py:140-199)."""

    def __init__(self, root: str, split: str = "train", max_items_per_img: int = 300):
        self.root = root
        self.split = "train" if split == "train" else "val"
        self.max_items = max_items_per_img
        ann = os.path.join(
            root, "wider_face_split", f"wider_face_{self.split}_bbx_gt.txt"
        )
        self.samples: list[tuple[str, np.ndarray]] = []
        img_root = os.path.join(root, f"WIDER_{self.split}", "images")
        with open(ann) as f:
            lines = [ln.rstrip("\n") for ln in f]
        i = 0
        while i < len(lines):
            rel = lines[i].strip()
            count = int(lines[i + 1])
            rows = lines[i + 2 : i + 2 + max(count, 1)]
            i += 2 + max(count, 1)  # a 0-count entry still has one dummy row
            boxes = []
            for r in rows[:count]:
                vals = r.split()
                x, y, w, h = (float(v) for v in vals[:4])
                if w > 0 and h > 0:
                    boxes.append([x, y, x + w, y + h])
            self.samples.append(
                (os.path.join(img_root, rel), np.asarray(boxes, np.float32))
            )

    def __len__(self) -> int:
        return len(self.samples)

    def _normalize(self, boxes_px: np.ndarray, w: float, h: float) -> np.ndarray:
        if not len(boxes_px):
            return np.zeros((0, 4), np.float32)
        # sort by area descending, cap (dataset.py:39-42, 54)
        areas = (boxes_px[:, 2] - boxes_px[:, 0]) * (boxes_px[:, 3] - boxes_px[:, 1])
        order = np.argsort(-areas)
        boxes_px = boxes_px[order][: self.max_items]
        boxes = boxes_px / np.asarray([w, h, w, h], np.float32)
        return np.clip(boxes, 0.0, 1.0)

    def __getitem__(self, idx: int):
        path, boxes_px = self.samples[idx]
        image = _load_image(path)
        h, w = image.shape[:2]
        boxes = self._normalize(boxes_px, w, h)
        labels = np.zeros((len(boxes),), np.int32)  # single class (dataset.py:62)
        return image, boxes, labels

    def raw_item(self, idx: int):
        """(jpeg_bytes, boxes, labels) for the loader's native decode pool;
        the image size comes from the JPEG's SOF header."""
        path, boxes_px = self.samples[idx]
        data = _read_jpeg_bytes(path)
        h, w = _jpeg_size(data)
        boxes = self._normalize(boxes_px, w, h)
        return data, boxes, np.zeros((len(boxes),), np.int32)


class VocDetection:
    """Pascal VOC from a VOCdevkit tree (datasets.py:202-272).

    ``keep_difficult=True`` (default) matches the reference, which parses
    every ``<object>`` regardless of the ``<difficult>`` flag
    (src/dataset/dataset.py:105-125). Standard VOC evaluation ignores
    difficult objects — pass ``keep_difficult=False`` for that protocol.
    """

    def __init__(
        self,
        root: str,
        split: str = "train",
        keep_difficult: bool = True,
    ):
        self.keep_difficult = keep_difficult
        # REFCOMPAT: split "valid" -> image set "trainval" (dataset.py:69-71)
        image_set = {"train": "train", "valid": "trainval", "val": "val"}.get(
            split, split
        )
        base = os.path.join(root, "VOCdevkit", "VOC2007")
        if not os.path.isdir(base):
            base = root  # allow pointing straight at a VOCxxxx dir
        with open(os.path.join(base, "ImageSets", "Main", f"{image_set}.txt")) as f:
            ids = [ln.strip().split()[0] for ln in f if ln.strip()]
        self.images = [os.path.join(base, "JPEGImages", f"{i}.jpg") for i in ids]
        self.annos = [os.path.join(base, "Annotations", f"{i}.xml") for i in ids]
        self.class_to_idx = {c: i for i, c in enumerate(VOC_CLASSES)}

    def __len__(self) -> int:
        return len(self.images)

    def _annotations(self, idx: int, w: float, h: float):
        tree = ET.parse(self.annos[idx])
        boxes, labels = [], []
        for obj in tree.findall("object"):
            name = (obj.findtext("name") or "").lower().strip()
            if name not in self.class_to_idx:
                continue
            if not self.keep_difficult and (obj.findtext("difficult") or "0").strip() == "1":
                continue
            bb = obj.find("bndbox")
            x1 = float(bb.findtext("xmin")) / w
            y1 = float(bb.findtext("ymin")) / h
            x2 = float(bb.findtext("xmax")) / w
            y2 = float(bb.findtext("ymax")) / h
            boxes.append([x1, y1, x2, y2])
            labels.append(self.class_to_idx[name])
        return (
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32),
        )

    def __getitem__(self, idx: int):
        image = _load_image(self.images[idx])
        h, w = image.shape[:2]
        boxes, labels = self._annotations(idx, w, h)
        return image, boxes, labels

    def raw_item(self, idx: int):
        """(jpeg_bytes, boxes, labels) for the loader's native decode pool;
        boxes are normalized by the XML's declared <size>."""
        data = _read_jpeg_bytes(self.images[idx])
        tree = ET.parse(self.annos[idx])
        size = tree.find("size")
        w = float(size.findtext("width"))
        h = float(size.findtext("height"))
        boxes, labels = self._annotations(idx, w, h)
        return data, boxes, labels


class CocoDetection:
    """COCO instances, 2017 layout: ``annotations/instances_{split}.json``
    (datasets.py:275-332)."""

    def __init__(self, root: str, split: str = "train2017"):
        ann_path = os.path.join(root, "annotations", f"instances_{split}.json")
        with open(ann_path) as f:
            coco = json.load(f)
        cat_ids = sorted(c["id"] for c in coco["categories"])
        self.cat_to_idx = {cid: i for i, cid in enumerate(cat_ids)}
        self.num_classes = len(cat_ids)
        images = {im["id"]: im for im in coco["images"]}
        anns_by_img: dict[int, list] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.samples = []
        img_dir = os.path.join(root, split)
        for img_id, im in images.items():
            anns = anns_by_img.get(img_id, [])
            self.samples.append(
                (
                    os.path.join(img_dir, im["file_name"]),
                    float(im["width"]),
                    float(im["height"]),
                    anns,
                )
            )

    def __len__(self) -> int:
        return len(self.samples)

    def _annotations(self, idx: int):
        path, w, h, anns = self.samples[idx]
        boxes, labels = [], []
        for a in anns:
            x, y, bw, bh = a["bbox"]
            if bw <= 0 or bh <= 0:
                continue
            boxes.append([x / w, y / h, (x + bw) / w, (y + bh) / h])
            labels.append(self.cat_to_idx[a["category_id"]])
        return (
            np.clip(np.asarray(boxes, np.float32).reshape(-1, 4), 0.0, 1.0),
            np.asarray(labels, np.int32),
        )

    def __getitem__(self, idx: int):
        boxes, labels = self._annotations(idx)
        return _load_image(self.samples[idx][0]), boxes, labels

    def raw_item(self, idx: int):
        """(jpeg_bytes, boxes, labels) for the loader's native decode pool;
        boxes are normalized by the size the instances JSON records."""
        path, _, _, _ = self.samples[idx]
        boxes, labels = self._annotations(idx)
        return _read_jpeg_bytes(path), boxes, labels


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
    if name == "widerface":
        return WiderFaceDetection(root, split, max_items_per_img)
    if name == "voc":
        return VocDetection(root, split)
    if name == "coco":
        # generic split names map to the 2017 layout
        coco_split = {"train": "train2017", "valid": "val2017", "val": "val2017"}.get(split, split)
        return CocoDetection(root, coco_split)
    raise ValueError(f"unknown dataset {name!r}")
