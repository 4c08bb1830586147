"""Minimal HTTP serving for batched detection, DESTR or SSD (port of
``object_detection_destr_tpu/infer/server.py``).

    python -m object_detection_destr_tpu_torch.infer.server \
        --model destr --checkpoint_dir checkpoints --weights model_weights --port 8900

Protocol (stdlib only):
    POST /predict   body = raw JPEG/PNG bytes (or JSON {"image_b64": ...})
    -> {"boxes": [[x1,y1,x2,y2], ...] (normalized), "scores": [...],
        "labels": [...]}
    GET /healthz    -> {"ok": true}

The model runs on the GPU unless ``--device cpu`` is given. ``--weights
NAME`` is a checkpoint that the port's trainer wrote into ``--checkpoint_dir``
(``--save_as``), restored as the JAX package's server restores one of its own
trainer's; flax weights come from the port's ``.npz`` file (models/convert.py)
when NAME ends in ``.npz`` or no checkpoint NAME exists. DESTR requests are
letterboxed by default (aspect-preserving, with a pixel valid-mask; boxes are
mapped back to the original image), or stretched with ``--no-letterbox``;
SSD requests are always stretched (to ``--image_size``, 300 by default), as
its reference evaluates (transforms.py:141-152), and decoded with
``ssd_predict``'s NMS.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..config import DestrConfig, SSDConfig, resolve_device
from ..data.loader import _letterbox_canvas, _resize_canvas
from ..data.transforms import letterbox_infer_transform, normalize_imagenet
from ..models.convert import load_flax_variables, load_variables_npz
from ..models.destr.model import build_destr
from ..models.ssd.model import build_ssd
from ..train.checkpoint import restore_for_inference
from ..train.steps import flat_anchors
from .predict import destr_predict, ssd_predict

__all__ = ["DetectionService", "serve", "get_parser", "build_model", "build_service", "load_weights"]


class DetectionService:
    """The model, its post-processing and the host preprocessing; thread-safe.

    ``model`` is a DESTR or (``model_kind="ssd"``) an SSD in eval mode with
    its weights loaded; it runs on the device its parameters are on. SSD
    never letterboxes. The predict function (the B=1 forward and
    ``destr_predict``, on the letterboxed input with its pixel mask or on
    the stretched input; or ``ssd_predict`` on the stretched input, against
    the default boxes placed on the device here) reads static input tensors
    and, on a GPU, is
    captured in a CUDA graph here, after a warm-up forward that builds the
    kernels: the counterpart of the JAX package's ``jax.jit`` predict
    compiled at startup (server.py:64-94). A request copies its input into
    the static tensors and replays the graph under the service's lock, and
    its detections are read from the graph's static outputs before the lock
    is released. On the CPU the same function runs eagerly.
    """

    def __init__(self, model_kind, model, image_size, score_thresh, letterbox=True):
        if model_kind not in ("destr", "ssd"):
            raise ValueError(f"model_kind={model_kind!r}")
        self.model_kind = model_kind
        self.model = model
        self.image_size = image_size
        self.score_thresh = score_thresh
        self.letterbox = letterbox and model_kind == "destr"
        self.device = next(model.parameters()).device
        self._lock = threading.Lock()
        self._anchors = flat_anchors(model.config, self.device) if model_kind == "ssd" else None
        self._images = torch.zeros((1, image_size, image_size, 3), device=self.device)
        self._pixel_valid = (torch.ones((1, image_size, image_size), dtype=torch.bool, device=self.device)
                             if self.letterbox else None)
        self.graph: torch.cuda.CUDAGraph | None = None
        if self.device.type == "cuda":
            self._capture()
        else:
            self._predict(self._images, self._pixel_valid)

    @torch.inference_mode()
    def _forward(self) -> dict[str, torch.Tensor]:
        """The predict function on the static inputs: detections on the device."""
        if self.model_kind == "ssd":
            return ssd_predict(self.model(self._images), self._anchors, score_thresh=self.score_thresh)
        outputs, _ = self.model(self._images, valid_mask=self._pixel_valid)
        return destr_predict(outputs, score_thresh=self.score_thresh)

    def _capture(self) -> None:
        """A warm-up forward on a side stream, then the capture."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._forward()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._outputs = self._forward()
        self.graph = graph

    @torch.inference_mode()
    def _predict(self, images, pixel_valid=None) -> dict[str, np.ndarray]:
        """Detections for one (1, S, S, 3) input (and its (1, S, S) pixel
        mask when letterboxed), as numpy; the caller holds the lock."""
        self._images.copy_(images)
        if self._pixel_valid is not None:
            self._pixel_valid.copy_(pixel_valid)
        if self.graph is None:
            dets = self._forward()
        else:
            self.graph.replay()
            dets = self._outputs
        return {k: v.cpu().numpy() for k, v in dets.items()}

    def predict_image(self, image_uint8: np.ndarray) -> dict:
        if self.letterbox:
            canvas, fh, fw = _letterbox_canvas(image_uint8, self.image_size)
            prep = letterbox_infer_transform(
                torch.from_numpy(canvas[None]).to(self.device),
                torch.tensor([[fh, fw]], dtype=torch.float32),
                out_size=self.image_size,
            )
            with self._lock:
                dets = self._predict(prep["images"], prep["pixel_valid"])
            keep = dets["valid"][0]
            # canvas-normalized xyxy -> original-image-normalized
            scale = np.asarray([fw, fh, fw, fh], np.float32)
            boxes = np.clip(dets["boxes"][0][keep] / scale, 0.0, 1.0)
        else:
            canvas = _resize_canvas(image_uint8, self.image_size)
            images = normalize_imagenet(torch.from_numpy(canvas[None]).to(self.device))
            with self._lock:
                dets = self._predict(images)
            keep = dets["valid"][0]
            boxes = dets["boxes"][0][keep]
        return {
            "boxes": boxes.tolist(),
            "scores": dets["scores"][0][keep].tolist(),
            "labels": dets["labels"][0][keep].tolist(),
        }


def _make_handler(service: DetectionService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    payload = json.loads(body)
                    body = base64.b64decode(payload["image_b64"])
                from PIL import Image

                image = np.asarray(
                    Image.open(io.BytesIO(body)).convert("RGB"), dtype=np.uint8
                )
                self._send(200, service.predict_image(image))
            except Exception as e:  # noqa: BLE001 — report to the client
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("object_detection_destr_tpu_torch serve")
    p.add_argument("--model", choices=["destr", "ssd"], default="destr")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--weights", type=str, default="model_weights",
                   help="a checkpoint of the trainer inside --checkpoint_dir, or "
                        "flax weights in NAME.npz ('.npz' is appended when no "
                        "checkpoint NAME exists)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--score_thresh", type=float, default=0.5)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--letterbox", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="aspect-preserving DESTR serving (default); "
                        "--no-letterbox restores the square stretch (SSD "
                        "always stretches)")
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--ffn_dim", type=int, default=2048)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_encoder_blocks", type=int, default=6)
    p.add_argument("--num_decoder_blocks", type=int, default=6)
    p.add_argument("--top_k", type=int, default=300)
    p.add_argument("--num_cls", type=int, default=2)
    p.add_argument("--backbone", type=str, default="resnet50")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU ('cpu' must be asked for)")
    return p


def load_weights(model, checkpoint_dir: str, weights: str) -> None:
    """A checkpoint of the port's trainer (``weights``, or its ``.new`` /
    ``.old`` stage), as JAX ``build_service`` (l.198-201) restores one; the
    ``.npz`` flax weights where ``weights`` ends in ``.npz`` or names no
    checkpoint."""
    if not weights.endswith(".npz"):
        try:
            model.load_state_dict(restore_for_inference(checkpoint_dir, weights))
            return
        except FileNotFoundError:
            weights += ".npz"
    load_flax_variables(model, load_variables_npz(os.path.join(checkpoint_dir, weights)))


def build_model(args, device: torch.device):
    """The server's and the CLI's model from their shared flags (server.py:198-219):
    DESTR at its shape flags, or SSD with ``num_cls`` 20 unless
    ``--num_cls`` is set away from DESTR's default 2 (the JAX package's rule);
    returns (model, default image size)."""
    if args.model == "ssd":
        return build_ssd(SSDConfig(num_cls=args.num_cls if args.num_cls != 2 else 20), device), 300
    cfg = DestrConfig(
        hidden_dim=args.hidden_dim, ffn_dim=args.ffn_dim,
        num_heads=args.num_heads,
        num_encoder_blocks=args.num_encoder_blocks,
        num_decoder_blocks=args.num_decoder_blocks,
        top_k=args.top_k, num_cls=args.num_cls, backbone=args.backbone,
        dilation=getattr(args, "dilation", False),
    )
    return build_destr(cfg, device), 640


def build_service(args) -> DetectionService:
    model, size = build_model(args, resolve_device(args.device))
    load_weights(model, args.checkpoint_dir, args.weights)
    return DetectionService(
        args.model, model, args.image_size or size, args.score_thresh,
        letterbox=args.letterbox,
    )


def serve(argv=None):
    args = get_parser().parse_args(argv)
    service = build_service(args)
    server = ThreadingHTTPServer((args.host, args.port), _make_handler(service))
    print(f"serving {args.model} on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    serve()
