"""Batch prediction CLI for both models (port of
``object_detection_destr_tpu/infer/cli.py``, l.1-173):

    python -m object_detection_destr_tpu_torch.infer.cli \\
        --model destr --checkpoint_dir checkpoints --weights model_weights \\
        --images img1.jpg img2.jpg --output dets.json

Loads the model's weights as the server does (a checkpoint of the port's
trainer, or ``.npz`` flax weights), runs the batched predict on the GPU
(``--device cpu`` for the CPU), and writes one JSON record per image:
{"file", "boxes" (xyxy, normalized to the original image), "scores",
"labels"}; ``--draw DIR`` also writes annotated PNGs. DESTR letterboxes by
default (``--no-letterbox`` stretches); SSD always stretches to 300 px.
:func:`predict_arrays` is the model-and-predict part on uint8 arrays, which
needs no image file. PIL, which reads and draws the files, is imported only
there.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import resolve_device
from ..data.loader import _letterbox_canvas, _resize_canvas
from ..data.transforms import letterbox_infer_transform, normalize_imagenet
from ..train.steps import flat_anchors
from .predict import destr_predict, ssd_predict
from .server import build_model, load_weights

__all__ = ["get_parser", "main", "predict_arrays"]


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("object_detection_destr_tpu_torch predict")
    p.add_argument("--model", choices=["destr", "ssd"], default="destr")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--weights", type=str, default="model_weights",
                   help="a checkpoint of the trainer inside --checkpoint_dir, or "
                        "flax weights in NAME.npz")
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--output", type=str, default="detections.json")
    p.add_argument("--draw", type=str, default=None, metavar="DIR",
                   help="also write annotated PNGs (detections drawn over "
                        "the original image) into DIR")
    p.add_argument("--score_thresh", type=float, default=0.5)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--letterbox", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="aspect-preserving DESTR inference: pad instead of "
                        "stretch, feed the pixel valid-mask to the model, and "
                        "report boxes in original-image coordinates; "
                        "--no-letterbox stretches (SSD always does)")
    # model shape flags must match the weights
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--ffn_dim", type=int, default=2048)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_encoder_blocks", type=int, default=6)
    p.add_argument("--num_decoder_blocks", type=int, default=6)
    p.add_argument("--top_k", type=int, default=300)
    p.add_argument("--num_cls", type=int, default=2)
    p.add_argument("--backbone", type=str, default="resnet50")
    p.add_argument("--dilation", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU ('cpu' must be asked for)")
    return p


@torch.no_grad()
def predict_arrays(model, model_kind: str, images: list, image_size: int, score_thresh: float = 0.5,
                   letterbox: bool = True) -> dict[str, np.ndarray]:
    """Detections for HWC uint8 ``images`` as one batch on the model's
    device (cli.py:91-136): {"boxes": (B, D, 4) xyxy normalized to each
    original image, "scores", "labels", "valid"}, numpy. DESTR letterboxed
    (the default) runs with the pixel valid-mask and maps its boxes from the
    canvas back to the image; otherwise each image is stretched to
    ``image_size``."""
    device = next(model.parameters()).device
    if letterbox and model_kind == "destr":
        placed = [_letterbox_canvas(image, image_size) for image in images]
        content = np.asarray([(fh, fw) for _, fh, fw in placed], np.float32)
        prep = letterbox_infer_transform(torch.from_numpy(np.stack([c for c, _, _ in placed])).to(device),
                                         torch.from_numpy(content), out_size=image_size)
        outputs, _ = model(prep["images"], valid_mask=prep["pixel_valid"])
        dets = {k: v.cpu().numpy() for k, v in destr_predict(outputs, score_thresh=score_thresh).items()}
        scale = np.stack([content[:, 1], content[:, 0], content[:, 1], content[:, 0]], -1)  # x / fw, y / fh
        dets["boxes"] = np.clip(dets["boxes"] / scale[:, None, :], 0.0, 1.0)
        return dets
    x = normalize_imagenet(torch.from_numpy(np.stack([_resize_canvas(im, image_size) for im in images])).to(device))
    if model_kind == "ssd":
        dets = ssd_predict(model(x), flat_anchors(model.config, device), score_thresh=score_thresh)
    else:
        outputs, _ = model(x)
        dets = destr_predict(outputs, score_thresh=score_thresh)
    return {k: v.cpu().numpy() for k, v in dets.items()}


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def main(argv=None) -> list[dict]:
    args = get_parser().parse_args(argv)
    model, size = build_model(args, resolve_device(args.device))
    load_weights(model, args.checkpoint_dir, args.weights)
    dets = predict_arrays(model, args.model, [_load_image(f) for f in args.images], args.image_size or size,
                          score_thresh=args.score_thresh, letterbox=args.letterbox)
    records = []
    for i, f in enumerate(args.images):
        keep = dets["valid"][i]
        records.append({"file": f, "boxes": dets["boxes"][i][keep].tolist(),
                        "scores": dets["scores"][i][keep].tolist(), "labels": dets["labels"][i][keep].tolist()})
    with open(args.output, "w") as fh:
        json.dump(records, fh)
    print(f"wrote {sum(len(r['boxes']) for r in records)} detections "
          f"for {len(records)} images -> {args.output}", flush=True)
    if args.draw:
        _draw_records(records, args.draw)
    return records


def _draw_records(records: list[dict], out_dir: str) -> None:
    """Annotated PNGs: detections (normalized xyxy) over the original image (cli.py:150-169)."""
    from PIL import Image, ImageDraw

    os.makedirs(out_dir, exist_ok=True)
    for rec in records:
        with Image.open(rec["file"]) as im:
            im = im.convert("RGB")
            w, h = im.size
            draw = ImageDraw.Draw(im)
            for box, score, label in zip(rec["boxes"], rec["scores"], rec["labels"]):
                x1, y1, x2, y2 = box[0] * w, box[1] * h, box[2] * w, box[3] * h
                draw.rectangle([x1, y1, x2, y2], outline=(0, 255, 0), width=2)
                draw.text((x1 + 2, max(y1 - 12, 0)), f"{label}:{score:.2f}", fill=(0, 255, 0))
            name = os.path.splitext(os.path.basename(rec["file"]))[0]
            im.save(os.path.join(out_dir, f"{name}_det.png"))
    print(f"wrote {len(records)} annotated images -> {out_dir}", flush=True)


if __name__ == "__main__":
    main()
