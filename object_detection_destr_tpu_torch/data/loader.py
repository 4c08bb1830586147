"""Canvas resize and letterbox (port of ``_resize_canvas`` and
``_letterbox_canvas``, ``object_detection_destr_tpu/data/loader.py:29-69``).

The JAX package resizes with cv2 (PIL as fallback); neither is certain to be
installed beside the port, so the resize is ``torch.nn.functional.interpolate``
(bilinear, ``align_corners=False``, the half-pixel sampling cv2's INTER_LINEAR
uses). cv2 rounds in fixed point, so the two differ by at most one grey level.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_uint8", "_resize_canvas", "_letterbox_canvas"]


def resize_uint8(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of an HWC uint8 image, rounded back to uint8."""
    x = torch.from_numpy(np.array(image, dtype=np.uint8)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False)
    y = y.round_().clamp_(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def _resize_canvas(image: np.ndarray, canvas: int) -> np.ndarray:
    """Resize HWC uint8 to (canvas, canvas, 3), stretching."""
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
