"""The port's WIDER FACE, VOC and COCO readers against the JAX package's, on
trees written here in each dataset's own on-disk format (the cases of
``tests/test_data.py``: the 0-count WIDER entry with its dummy row,
zero-size rows, extra attribute columns, the area order and the cap; VOC's
reference class order, ``difficult`` and the "valid" -> "trainval" split;
COCO's crowd annotations, category order and 2017 split names), and
``raw_item``. Items, boxes, labels and raw bytes must be identical.
"""

import json
import xml.etree.ElementTree as ET

import numpy as np
import pytest
from PIL import Image

jax = pytest.importorskip("jax")

from object_detection_destr_tpu.data import datasets as jax_ds  # noqa: E402
from object_detection_destr_tpu_torch.data import datasets as ds  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401


def write_widerface(root, split="train", sizes=((40, 60), (50, 30), (36, 36)), seed=0, quality=92):
    """A WIDER FACE tree: one JPEG a size with 1-3 faces each (one zero-size
    row, one row with attribute columns set), and a 0-count entry."""
    rng = np.random.default_rng(seed)
    (root / "wider_face_split").mkdir(parents=True, exist_ok=True)
    lines = []
    for i, (h, w) in enumerate(sizes):
        rel = f"{i}--Event/img_{i}.jpg"
        (root / f"WIDER_{split}" / "images" / f"{i}--Event").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / f"WIDER_{split}" / "images" / rel, quality=quality)
        rows = [f"{int(rng.integers(0, w // 2))} {int(rng.integers(0, h // 2))} {int(rng.integers(2, w // 2))} "
                f"{int(rng.integers(2, h // 2))} 0 0 0 0 0 0" for _ in range(1 + i % 3)]
        if i == 1:
            rows.append("5 5 0 0 0 0 0 0 0 0")  # zero size: dropped
            rows.append("3 4 9 7 2 0 1 1 1 0")  # attributes and the invalid flag: kept
        lines += [rel, str(len(rows)), *rows]
    lines += ["0--Event/img_0.jpg", "0", "0 0 0 0 0 0 0 0 0 0"]  # a 0-count entry, its dummy row
    (root / "wider_face_split" / f"wider_face_{split}_bbx_gt.txt").write_text("\n".join(lines) + "\n")
    return root


def _write_voc(root):
    base = root / "VOCdevkit" / "VOC2007"
    for sub in ["ImageSets/Main", "Annotations", "JPEGImages"]:
        (base / sub).mkdir(parents=True)
    rng = np.random.default_rng(1)
    ids = ["000001", "000002"]
    for split, chosen in (("train", ids[:1]), ("trainval", ids), ("val", ids[1:])):
        (base / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(chosen) + "\n")
    objects = {"000001": [("dog", "0", 10), ("Person ", "1", 40), ("unicorn", "0", 5)],
               "000002": [("tvmonitor", "0", 20), ("aeroplane", "1", 2)]}
    for i in ids:
        Image.fromarray(rng.integers(0, 255, (50, 100, 3), dtype=np.uint8)).save(base / "JPEGImages" / f"{i}.jpg")
        root_el = ET.Element("annotation")
        size = ET.SubElement(root_el, "size")
        ET.SubElement(size, "width").text = "100"
        ET.SubElement(size, "height").text = "50"
        for name, difficult, x1 in objects[i]:
            obj = ET.SubElement(root_el, "object")
            ET.SubElement(obj, "name").text = name
            ET.SubElement(obj, "difficult").text = difficult
            bb = ET.SubElement(obj, "bndbox")
            for tag, v in [("xmin", x1), ("ymin", 5), ("xmax", x1 + 30), ("ymax", 45)]:
                ET.SubElement(bb, tag).text = str(v)
        ET.ElementTree(root_el).write(base / "Annotations" / f"{i}.xml")


def _write_coco(root):
    rng = np.random.default_rng(2)
    (root / "annotations").mkdir()
    for split in ("train2017", "val2017"):
        (root / split).mkdir()
        images, anns = [], []
        for i, (h, w, ext) in enumerate([(80, 40, "jpg"), (30, 50, "jpg"), (20, 20, "png")]):
            Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(root / split / f"{i}.{ext}")
            images.append({"id": i + 1, "file_name": f"{i}.{ext}", "width": w, "height": h})
            anns += [{"id": 10 * i + 1, "image_id": i + 1, "category_id": 18, "bbox": [1, 2, w / 2, h / 3],
                      "iscrowd": 0},
                     {"id": 10 * i + 2, "image_id": i + 1, "category_id": 3, "bbox": [0, 0, w, h], "iscrowd": 1},
                     {"id": 10 * i + 3, "image_id": i + 1, "category_id": 3, "bbox": [2, 2, 0, 5], "iscrowd": 0},
                     {"id": 10 * i + 4, "image_id": i + 1, "category_id": 3, "bbox": [w / 4, 1, w, h], "iscrowd": 0}]
        coco = {"images": images, "annotations": anns,
                "categories": [{"id": 18, "name": "dog"}, {"id": 3, "name": "car"}, {"id": 7, "name": "x"}]}
        (root / "annotations" / f"instances_{split}.json").write_text(json.dumps(coco))


def _same_items(ours, ref, raw=True):
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
        if raw:
            for a, b in zip(ours.raw_item(i), ref.raw_item(i)):
                if isinstance(b, bytes):
                    assert a == b
                else:
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [300, 1])
def test_widerface_matches_jax(tmp_path, cap):
    write_widerface(tmp_path)
    write_widerface(tmp_path, "val", sizes=((30, 20),), seed=5)
    for split in ("train", "val"):
        ours = ds.build_dataset("widerface", str(tmp_path), split, max_items_per_img=cap)
        ref = jax_ds.build_dataset("widerface", str(tmp_path), split, max_items_per_img=cap)
        assert isinstance(ours, ds.WiderFaceDetection)
        _same_items(ours, ref)
    ours = ds.WiderFaceDetection(str(tmp_path), "train", cap)
    assert len(ours) == 4 and ours[3][1].shape == (0, 4)  # the 0-count entry: no boxes
    _, boxes, labels = ours[1]
    assert len(boxes) == min(3, cap) and (labels == 0).all()  # the zero-size row dropped
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    assert (np.diff(areas) <= 0).all()  # largest first
    assert ds._jpeg_size(ours.raw_item(0)[0]) == (40, 60)


def test_voc_matches_jax(tmp_path):
    _write_voc(tmp_path)
    assert ds.VOC_CLASSES == jax_ds.VOC_CLASSES and ds.VOC_CLASSES[:2] == ("person", "bird")
    for split, n in (("train", 1), ("valid", 2), ("val", 1)):  # "valid" reads trainval (the reference's quirk)
        ours = ds.build_dataset("voc", str(tmp_path), split)
        _same_items(ours, jax_ds.build_dataset("voc", str(tmp_path), split))
        assert len(ours) == n
    _, _, labels = ds.VocDetection(str(tmp_path), "train")[0]
    assert labels.tolist() == [4, 0]  # dog, person; the unknown class is skipped
    strict = ds.VocDetection(str(tmp_path), "train", keep_difficult=False)
    _same_items(strict, jax_ds.VocDetection(str(tmp_path), "train", keep_difficult=False))
    assert strict[0][2].tolist() == [4]


def test_coco_matches_jax(tmp_path):
    _write_coco(tmp_path)
    for split in ("train", "valid", "val", "val2017"):
        ours = ds.build_dataset("coco", str(tmp_path), split)
        ref = jax_ds.build_dataset("coco", str(tmp_path), split)
        _same_items(ours, ref, raw=False)
        assert ours.num_classes == ref.num_classes == 3
    ours = ds.CocoDetection(str(tmp_path), "train2017")
    ref = jax_ds.CocoDetection(str(tmp_path), "train2017")
    for i in range(2):  # JPEGs
        for a, b in zip(ours.raw_item(i), ref.raw_item(i)):
            assert a == b if isinstance(b, bytes) else np.array_equal(a, b)
    with pytest.raises(AttributeError):  # the PNG: no raw path
        ours.raw_item(2)
    _, boxes, labels = ours[0]
    assert labels.tolist() == [2, 0]  # category 18 -> 2, 3 -> 0 (id order); crowd and zero-size skipped
    assert boxes.max() <= 1.0
