"""Batching host loader, canvas resize and letterbox (port of
``object_detection_destr_tpu/data/loader.py``: ``_resize_canvas`` and
``_letterbox_canvas`` l.29-69, ``DetectionLoader`` l.72-265).

A batch is made on one of JAX ``_make_batch``'s paths, in its order
(loader.py:120-222):

1. letterbox: items decoded one by one, each resized with its aspect kept
   and pasted top-left on a zero canvas;
2. the native JPEG pool (``runtime/native.py``): where the dataset has
   ``raw_item``, the batch's JPEG bytes are decoded and resized in one
   threaded call; a non-JPEG file or a failed decode (``AttributeError`` /
   ``ValueError``) sends the batch to path 3;
3. decoded arrays: items decoded one by one, resized by the native pool's
   ``batch_resize``.

Where the native library cannot be built (no ``g++``, or no libjpeg for
path 2), the loader says so once and takes the next path; where it has no
native resize at all, it resizes with ``torch.nn.functional.interpolate``
(bilinear, ``align_corners=False``, the half-pixel sampling of cv2's
INTER_LINEAR and of the native pool), as the letterbox does. cv2 and the
native pool round in other ways than PyTorch, so the paths differ by a grey
level or two.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime import native

__all__ = ["DetectionLoader", "resize_uint8", "_resize_canvas", "_letterbox_canvas"]


def resize_uint8(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of an HWC uint8 image, rounded back to uint8."""
    x = torch.from_numpy(np.array(image, dtype=np.uint8)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False)
    y = y.round_().clamp_(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def _resize_canvas(image: np.ndarray, canvas: int) -> np.ndarray:
    """Resize HWC uint8 to (canvas, canvas, 3), stretching; an image already
    at the canvas size is returned as it is."""
    if image.shape[:2] == (canvas, canvas):
        return np.array(image, dtype=np.uint8)
    return resize_uint8(image, canvas, canvas)


def _letterbox_canvas(image: np.ndarray, canvas: int):
    """Aspect-preserving resize onto a zero (canvas, canvas, 3) canvas,
    content pasted top-left. Returns (canvas_image, fh, fw) where fh/fw are
    the content extents as fractions of the canvas."""
    ih, iw = image.shape[:2]
    scale = canvas / max(ih, iw)
    nh = max(int(round(ih * scale)), 1)
    nw = max(int(round(iw * scale)), 1)
    out = np.zeros((canvas, canvas, 3), np.uint8)
    out[:nh, :nw] = resize_uint8(image, nh, nw)
    return out, nh / canvas, nw / canvas


class DetectionLoader:
    """Iterate padded numpy batches (loader.py:72-265).

    Batch: {"images": (B, C, C, 3) uint8, "boxes": (B, T, 4) xyxy norm,
            "labels": (B, T) int32, "valid": (B, T) bool}

    Virtual epochs of ``len(dataset) * augment_factor`` samples (index mod
    the dataset), shuffled per epoch from ``(seed, epoch)``, ``drop_last``,
    items fetched by a thread pool and batches made one or more ahead by a
    prefetch thread. With ``letterbox=True`` images are aspect-preserving
    resized and pasted top-left on a zero canvas; the batch gains
    "content_hw": (B, 2) and boxes are in canvas coordinates.

    With a data-parallel ``mesh`` (``parallel.Mesh``; loader.py:97-117,
    228-231) ``batch_size`` is the global batch: every rank builds the same
    epoch order and makes only its rows of each batch (``Mesh.rows``), which
    ``shard_batch`` of the global batch would give it.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        canvas_size: int = 672,
        max_targets: int = 300,
        augment_factor: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        num_workers: int = 8,
        letterbox: bool = False,
        mesh=None,
    ):
        self.dataset = dataset
        self.mesh = mesh
        self.batch_size = batch_size
        self.canvas_size = canvas_size
        self.letterbox = letterbox
        self.max_targets = max_targets
        self.augment_factor = max(augment_factor, 1)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._pool = ThreadPoolExecutor(num_workers) if num_workers > 0 else None
        self._noticed: set[str] = set()  # native libraries this loader said it goes without
        self.epoch = 0
        self._start_step = 0
        self._step = 0

    @property
    def num_samples(self) -> int:
        return len(self.dataset) * self.augment_factor

    def __len__(self) -> int:
        n = self.num_samples
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "step": self._step}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self._start_step = int(state["step"])
        self._step = self._start_step

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(self.num_samples)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        return order

    def _native_ready(self, name: str) -> bool:
        """Whether native library ``name`` ("jpeg" or "resize") is there; the
        first time it is not, the loader says why and which path it takes."""
        ready = native.jpeg_available() if name == "jpeg" else native.is_available()
        if not ready and name not in self._noticed:
            self._noticed.add(name)
            instead = "decoded arrays" if name == "jpeg" else "a torch resize"
            print(f"loader: native {name} library unavailable ({native.unavailable_reason(name)}); "
                  f"using {instead}", flush=True)
        return ready

    def _fetch(self, idxs: np.ndarray, raw: bool = False) -> list:
        """The items of virtual indices ``idxs`` (``raw_item`` with ``raw``),
        fetched over the thread pool."""
        get = self.dataset.raw_item if raw else self.dataset.__getitem__
        fetch = lambda vi: get(int(vi) % len(self.dataset))
        return list(self._pool.map(fetch, idxs)) if self._pool is not None else [fetch(i) for i in idxs]

    def _make_batch(self, idxs: np.ndarray) -> dict:
        c, t = self.canvas_size, self.max_targets
        b = len(idxs)
        boxes = np.zeros((b, t, 4), np.float32)
        labels = np.zeros((b, t), np.int32)
        valid = np.zeros((b, t), bool)

        def targets(items, scales=None) -> None:
            for j, (_, bx, lb) in enumerate(items):
                n = min(len(bx), t)
                if n:
                    boxes[j, :n] = bx[:n] if scales is None else bx[:n] * scales[j]
                    labels[j, :n] = lb[:n]
                    valid[j, :n] = True

        batch = {"boxes": boxes, "labels": labels, "valid": valid}
        if self.letterbox:
            items = self._fetch(idxs)
            images = np.zeros((b, c, c, 3), np.uint8)
            content_hw = np.zeros((b, 2), np.float32)
            scales = []
            for j, (img, _, _) in enumerate(items):
                images[j], fh, fw = _letterbox_canvas(img, c)
                content_hw[j] = (fh, fw)
                scales.append(np.asarray([fw, fh, fw, fh], np.float32))  # to canvas coordinates
            targets(items, scales)
            return {"images": images, **batch, "content_hw": content_hw}

        if hasattr(self.dataset, "raw_item") and self._native_ready("jpeg"):
            try:
                items = self._fetch(idxs, raw=True)
                images = native.batch_decode_resize([it[0] for it in items], c)
                targets(items)
                return {"images": images, **batch}
            except (AttributeError, ValueError):
                pass  # non-JPEG files or a failed decode: the decoded-array path

        items = self._fetch(idxs)
        targets(items)
        if self._native_ready("resize"):
            images = native.batch_resize([img for img, _, _ in items], c)
        else:
            images = np.stack([_resize_canvas(img, c) for img, _, _ in items])
        return {"images": images, **batch}

    def __iter__(self) -> Iterator[dict]:
        order = self._epoch_order()
        n_batches = len(self)
        start = self._start_step
        self._start_step = 0

        def batches():
            for step in range(start, n_batches):
                self._step = step + 1
                lo = step * self.batch_size
                idxs = order[lo : lo + self.batch_size]
                yield self._make_batch(idxs if self.mesh is None else idxs[self.mesh.rows(len(idxs))])
            self.epoch += 1
            self._step = 0

        self._step = start
        if self.prefetch <= 0:
            yield from batches()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for item in batches():
                    q.put(item)
            finally:
                q.put(sentinel)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        th.join()
