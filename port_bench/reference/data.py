"""The inputs as the program's loaders make them, worked out again from the
raw tree: a frozen copy of the COCO reader's annotations
(``object_detection_destr_tpu_torch/data/datasets.py::CocoDetection``
l.274-323), of the native pool's bilinear canvas resize
(``runtime/cc/batch_resize.cc`` l.28-62, float32 in the same order, the
``+ 0.5`` truncation) and of the loader's padded targets (``data/loader.py``
l.160-172). Images are decoded with PIL."""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

__all__ = ["coco_items", "decode", "resize_canvas", "padded_targets"]


def coco_items(root: str, split: str = "train2017") -> list[tuple[str, np.ndarray, np.ndarray]]:
    """[(path, boxes (n, 4) normalized xyxy, labels (n,) int32)] in the
    reader's order: crowd and zero-sized annotations left out, labels the
    rank of the category id."""
    with open(os.path.join(root, "annotations", f"instances_{split}.json")) as f:
        coco = json.load(f)
    cat_to_idx = {cid: i for i, cid in enumerate(sorted(c["id"] for c in coco["categories"]))}
    anns_by_img: dict[int, list] = {}
    for a in coco.get("annotations", []):
        if not a.get("iscrowd", 0):
            anns_by_img.setdefault(a["image_id"], []).append(a)
    items = []
    for im in coco["images"]:
        w, h = float(im["width"]), float(im["height"])
        boxes, labels = [], []
        for a in anns_by_img.get(im["id"], []):
            x, y, bw, bh = a["bbox"]
            if bw <= 0 or bh <= 0:
                continue
            boxes.append([x / w, y / h, (x + bw) / w, (y + bh) / h])
            labels.append(cat_to_idx[a["category_id"]])
        items.append((os.path.join(root, split, im["file_name"]),
                      np.clip(np.asarray(boxes, np.float32).reshape(-1, 4), 0.0, 1.0),
                      np.asarray(labels, np.int32)))
    return items


def decode(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def resize_canvas(image: np.ndarray, canvas: int) -> np.ndarray:
    """Bilinear (half-pixel centres, edges clamped) HWC uint8 resize to
    (canvas, canvas), in float32 as the native pool computes it."""
    sh, sw = image.shape[:2]
    f32 = np.float32
    pos = np.arange(canvas, dtype=f32) + f32(0.5)

    def axis(size):
        f = pos * (f32(size) / f32(canvas)) - f32(0.5)
        f = np.minimum(np.maximum(f, f32(0.0)), f32(size - 1))
        i0 = f.astype(np.int64)
        return i0, np.minimum(i0 + 1, size - 1), (f - i0.astype(f32)).astype(f32)

    y0, y1, wy = axis(sh)
    x0, x1, wx = axis(sw)
    one = f32(1.0)
    wy, wx = wy[:, None, None], wx[None, :, None]
    w00, w01 = (one - wy) * (one - wx), (one - wy) * wx
    w10, w11 = wy * (one - wx), wy * wx
    src = image.astype(f32)
    p00, p01 = src[y0][:, x0], src[y0][:, x1]
    p10, p11 = src[y1][:, x0], src[y1][:, x1]
    v = w00 * p00 + w01 * p01 + w10 * p10 + w11 * p11
    return (v + f32(0.5)).astype(np.uint8)


def padded_targets(items, max_targets: int) -> dict[str, np.ndarray]:
    """The loader's (B, T) targets of ``items`` [(boxes, labels)]."""
    b = len(items)
    boxes = np.zeros((b, max_targets, 4), np.float32)
    labels = np.zeros((b, max_targets), np.int32)
    valid = np.zeros((b, max_targets), bool)
    for j, (bx, lb) in enumerate(items):
        n = min(len(bx), max_targets)
        boxes[j, :n], labels[j, :n], valid[j, :n] = bx[:n], lb[:n], True
    return {"boxes": boxes, "labels": labels, "valid": valid}

