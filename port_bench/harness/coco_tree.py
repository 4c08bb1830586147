"""The training set of a cell: a COCO 2017 tree written from the seed, a
copy of ``chip_smoke.py::write_coco_tree`` l.4962-5010 with its constants
(l.4937-4939): COCO's 80 category ids with their gaps, JPEGs at COCO's five
common sizes in turn, 1-20 boxes an image over all 80 classes, a crowd and
a zero-width annotation on every fourth image, which the reader skips. The
changes: a split of no images is not written, and the JPEGs are encoded on
eight threads."""

from __future__ import annotations

import json
import os

__all__ = ["COCO_CATEGORY_IDS", "COCO_SIZES", "write_coco_tree"]

COCO_CATEGORY_IDS = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
COCO_SIZES = [(480, 640), (640, 480), (427, 640), (375, 500), (640, 427)]  # (H, W): COCO's common sizes


def write_coco_tree(root, seed, n_train, n_valid=0, sizes=COCO_SIZES, quality=90):
    """A COCO 2017 tree in the reader's layout: ``annotations/instances_
    {train,val}2017.json`` with COCO's 80 category ids and, under
    ``{train,val}2017/``, seeded JPEGs of ``sizes`` (H, W) in turn, each a
    smooth coloured background with 1-20 bright boxes; the boxes' classes
    run through a seeded permutation of the 80 in turn, so a split with 80
    boxes or more holds every class. Every fourth image also carries a crowd
    annotation and a zero-width one, which the reader skips. Returns
    {split: (images, boxes the reader keeps)}."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    pool = ThreadPoolExecutor(8)  # the encodes run beside the seeded draws, which stay in order
    saves = []

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    categories = [{"id": c, "name": f"category_{c}", "supercategory": "object"} for c in COCO_CATEGORY_IDS]
    out = {}
    for split, n in (("train2017", n_train), ("val2017", n_valid)):
        if not n:
            continue
        os.makedirs(os.path.join(root, split), exist_ok=True)
        order = rng.permutation(len(COCO_CATEGORY_IDS))
        images, annotations, kept = [], [], 0

        def annotate(image_id, box, category, crowd=0):
            annotations.append({"id": len(annotations) + 1, "image_id": image_id, "category_id": int(category),
                                "bbox": [round(float(v), 2) for v in box], "area": float(box[2] * box[3]),
                                "iscrowd": crowd})

        for i in range(n):
            h, w = sizes[i % len(sizes)]
            image_id = i + 1
            coarse = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
            image = np.array(Image.fromarray(coarse).resize((w, h), Image.BILINEAR))
            for _ in range(int(rng.integers(1, 21))):
                bw, bh = rng.uniform(0.05, 0.6) * w, rng.uniform(0.05, 0.6) * h
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                image[int(y):int(y + bh), int(x):int(x + bw)] = rng.integers(100, 256, 3)
                annotate(image_id, (x, y, bw, bh), COCO_CATEGORY_IDS[order[kept % len(order)]])
                kept += 1
            if i % 4 == 0:
                annotate(image_id, (0, 0, w, h), COCO_CATEGORY_IDS[0], crowd=1)
                annotate(image_id, (w / 3, h / 3, 0, h / 4), COCO_CATEGORY_IDS[1])
            name = f"{image_id:012d}.jpg"
            saves.append(pool.submit(Image.fromarray(image).save, os.path.join(root, split, name), quality=quality))
            images.append({"id": image_id, "file_name": name, "width": w, "height": h})
        with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
        out[split] = (n, kept)
    for done in saves:
        done.result()
    pool.shutdown()
    return out
