"""Inference transforms (port of ``normalize_imagenet`` and
``letterbox_infer_transform``, ``object_detection_destr_tpu/data/transforms.py:47-51, :222-245``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_imagenet", "letterbox_infer_transform"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    """Scale [0, 255] uint8/float NHWC -> ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device) * 255.0
    return (images.float() - mean) / std


def letterbox_infer_transform(
    images: torch.Tensor, content_hw: torch.Tensor, out_size: int = 640
) -> dict[str, torch.Tensor]:
    """Whole-canvas resize + pixel validity mask, for serving.

    Args:
        images: (B, H, W, 3) letterboxed canvases.
        content_hw: (B, 2) content extents as fractions of the canvas.

    Returns:
        {"images": (B, S, S, 3) normalized float32,
         "pixel_valid": (B, S, S) bool}. When S equals the canvas, as it
        always does in the server, the resample is the identity.
    """
    _, h, w, _ = images.shape
    x = images.float()
    if (h, w) != (out_size, out_size):
        x = F.interpolate(
            x.permute(0, 3, 1, 2), size=(out_size, out_size), mode="bilinear",
            align_corners=False, antialias=out_size < max(h, w),
        ).permute(0, 2, 3, 1)
    frac = (torch.arange(out_size, dtype=torch.float32, device=images.device) + 0.5) / out_size
    content = content_hw.to(device=images.device, dtype=torch.float32)
    pixel_valid = (frac[None, :, None] < content[:, 0, None, None]) & (
        frac[None, None, :] < content[:, 1, None, None]
    )
    return {"images": normalize_imagenet(x), "pixel_valid": pixel_valid}
