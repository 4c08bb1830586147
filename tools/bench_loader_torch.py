"""Host input-pipeline throughput of the PyTorch port's loader: the port's
counterpart of ``tools/bench_loader.py``.

Measures ``data/loader.py::DetectionLoader``'s images/s on real JPEG bytes
through the native pool (``runtime/native.py``: the fused libjpeg decode and
resize where libjpeg's headers let it build, else PIL's decode and the
native resize), and names the decode path taken. Without ``--root`` it
writes a synthetic COCO-layout corpus (JPEG files of ``--image-hw``, not
square, and an instances JSON; its own copy of ``build_synthetic_coco``
over the port's ``SyntheticDetection``) under the temporary directory, so
the measured path is the real one: file read, annotation parse, decode and
resize, padded batch. ``--root`` / ``--dataset`` point at a WIDER FACE, VOC
or COCO tree instead. No kernel runs; nothing touches the GPU.

    python tools/bench_loader_torch.py [--num-images 512] [--image-hw 600 800]
        [--batch_size 8] [--canvas 672] [--num_workers 8] [--letterbox]
        [--no-native] [--decode-only] [--workers-sweep 1,2,4,8]

``--no-native`` marks both native libraries failed in ``runtime/native.py``
(the reason ``unavailable_reason`` then reports) for the run, so the loader
takes PIL's decode and its torch resize; the marks are taken back at the
end. Prints one JSON line last with images/s, the path and the host's
cores. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

NO_NATIVE = "disabled by bench_loader_torch --no-native"


def build_synthetic_coco(root: str, n: int, hw, quality: int = 90, seed: int = 0) -> None:
    """COCO-layout corpus: root/train2017/*.jpg and
    root/annotations/instances_train2017.json, n images of hw = (h, w)."""
    from PIL import Image

    from object_detection_destr_tpu_torch.data.datasets import SyntheticDetection

    img_dir = os.path.join(root, "train2017")
    ann_dir = os.path.join(root, "annotations")
    marker = os.path.join(root, f"corpus_{n}_{hw[0]}x{hw[1]}_q{quality}.ok")
    if os.path.exists(marker):
        return
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    ds = SyntheticDetection(num_samples=n, image_size=hw[0], max_boxes=6, seed=seed,
                            aspect_ratios=(hw[1] / hw[0],))
    images, annotations = [], []
    ann_id = 1
    for i in range(n):
        img, boxes, _ = ds[i]
        h, w = img.shape[:2]
        name = f"{i:012d}.jpg"
        Image.fromarray(img).save(os.path.join(img_dir, name), quality=quality)
        images.append({"id": i, "file_name": name, "width": w, "height": h})
        for b in boxes:
            x1, y1, x2, y2 = (b * [w, h, w, h]).tolist()
            annotations.append({"id": ann_id, "image_id": i, "category_id": 1,
                                "bbox": [x1, y1, x2 - x1, y2 - y1], "iscrowd": 0})
            ann_id += 1
    with open(os.path.join(ann_dir, "instances_train2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "object"}]}, f)
    open(marker, "w").close()


@contextlib.contextmanager
def native_disabled(native, disable: bool):
    """Both native libraries marked failed in ``native`` for the body (when
    ``disable``; a library this process loaded already is set aside), and
    put back as they were after."""
    names = ("resize", "jpeg") if disable else ()
    saved = {name: (native._libs.pop(name, None), native._failed.get(name)) for name in names}
    for name in names:
        native._failed[name] = NO_NATIVE
    try:
        yield
    finally:
        for name, (lib, failed) in saved.items():
            native._failed.pop(name, None)
            if failed is not None:
                native._failed[name] = failed
            if lib is not None:
                native._libs[name] = lib


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("bench_loader_torch")
    ap.add_argument("--root", type=str, default=None, help="a dataset root; default: the synthetic JPEG corpus")
    ap.add_argument("--dataset", type=str, default="coco", choices=["coco", "widerface", "voc"])
    ap.add_argument("--split", type=str, default="train")
    ap.add_argument("--num-images", type=int, default=512)
    ap.add_argument("--image-hw", type=int, nargs=2, default=(600, 800),
                    help="the synthetic corpus' image size (h w), not square")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--canvas", type=int, default=672)
    ap.add_argument("--max_targets", type=int, default=300)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--num-batches", type=int, default=0, help="0 = one full pass")
    ap.add_argument("--letterbox", action="store_true")
    ap.add_argument("--no-native", action="store_true",
                    help="mark the native libraries failed: PIL's decode and the torch resize")
    ap.add_argument("--decode-only", action="store_true",
                    help="also time the bare native decode + resize call over the corpus' bytes")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--workers-sweep", type=str, default=None,
                    help="comma-separated worker counts: images/s at each (on a host of one core every "
                         "count measures the same rate)")
    return ap


def main(argv=None) -> dict:
    from object_detection_destr_tpu_torch.data.datasets import build_dataset
    from object_detection_destr_tpu_torch.data.loader import DetectionLoader
    from object_detection_destr_tpu_torch.runtime import native

    args = get_parser().parse_args(argv)
    root = args.root
    if root is None:
        hw = tuple(args.image_hw)
        root = os.path.join(tempfile.gettempdir(), f"bench_loader_corpus_{args.num_images}_{hw[0]}x{hw[1]}")
        build_synthetic_coco(root, args.num_images, hw)
    ds = build_dataset(args.dataset, root, args.split)

    def measure(num_workers: int) -> float:
        loader = DetectionLoader(ds, batch_size=args.batch_size, canvas_size=args.canvas,
                                 max_targets=args.max_targets, shuffle=True, seed=0, prefetch=args.prefetch,
                                 num_workers=num_workers, letterbox=args.letterbox)
        n_batches = args.num_batches or len(loader)
        best = None
        for _ in range(args.repeats):
            it = iter(loader)
            next(it)  # warm the pool and the page cache outside the window
            t0 = time.perf_counter()
            count = 0
            for batch in it:
                count += batch["images"].shape[0]
                if count >= (n_batches - 1) * args.batch_size:
                    break
            rate = count / (time.perf_counter() - t0)
            best = rate if best is None else max(best, rate)
        return best

    with native_disabled(native, args.no_native):
        if args.letterbox:
            path = "letterbox (PIL decode, torch resize)"
        elif hasattr(ds, "raw_item") and native.jpeg_available():
            path = "native fused decode+resize"
        elif native.is_available():
            path = "PIL decode, native batch_resize"
        else:
            path = "PIL decode, torch resize"
        best = measure(args.num_workers)
        result = {
            "metric": (f"host loader images/sec ({args.dataset}, canvas {args.canvas}, b{args.batch_size}, "
                       f"{args.num_workers} workers, {path}, {os.cpu_count()} host cores)"),
            "value": round(best, 1),
            "unit": "images/sec",
            "path": path,
            "native_unavailable": {name: native.unavailable_reason(name).splitlines()[0]
                                   for name in ("resize", "jpeg") if native.unavailable_reason(name)},
            "host_cores": os.cpu_count(),
        }
        if args.workers_sweep:
            result["workers_sweep"] = {n: round(measure(int(n)), 1) for n in args.workers_sweep.split(",")}
        if args.decode_only and hasattr(ds, "raw_item") and native.jpeg_available():
            blobs = [ds.raw_item(i)[0] for i in range(min(len(ds), 256))]
            native.batch_decode_resize(blobs[: args.batch_size], args.canvas)  # warm
            reps = max(1, 256 // len(blobs))
            t0 = time.perf_counter()
            for _ in range(reps):
                for lo in range(0, len(blobs), args.batch_size):
                    native.batch_decode_resize(blobs[lo: lo + args.batch_size], args.canvas)
            result["decode_only_images_per_sec"] = round(reps * len(blobs) / (time.perf_counter() - t0), 1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
