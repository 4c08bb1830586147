"""The device transforms in plain PyTorch: a frozen copy of
``object_detection_destr_tpu_torch/data/transforms.py`` l.37-233
(``normalize_imagenet``, ``crop_flip`` and ``destr_train_transform`` on
one device). The train transform's draws come
from a generator the caller seeds as the trainer seeds its own."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .boxes import flat_box_mask

__all__ = ["crop_flip", "destr_train_transform", "normalize_imagenet"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# the float32 products mean * 255 and std * 255, as Python floats (exact):
# constants enter the ops as scalars, with no host-to-device copy, so a CUDA
# graph can capture the transforms
_MEAN_255 = tuple(float(np.float32(m) * np.float32(255.0)) for m in IMAGENET_MEAN)
_STD_255 = tuple(float(np.float32(s) * np.float32(255.0)) for s in IMAGENET_STD)


def normalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    """Scale [0, 255] uint8/float NHWC -> ImageNet-normalized float32."""
    x = images.float()
    return torch.stack([(x[..., c] - m) / s for c, (m, s) in enumerate(zip(_MEAN_255, _STD_255))], -1)


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(B, in, out) resampling weights of ``jax.image.scale_and_translate``
    with the linear (triangle) kernel and antialiasing: the kernel widens by
    1/scale when downsampling; columns are normalized, and zero where the
    sample falls outside the input."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, device=dev, dtype=torch.float32) + 0.5) * inv_scale \
        - translation[:, None] * inv_scale - 0.5  # (B, out)
    x = torch.abs(sample_f[:, None, :] - torch.arange(in_size, device=dev, dtype=torch.float32)[None, :, None])
    weights = torch.clamp(1.0 - x / kernel_scale[:, None], min=0.0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, 1.0), 0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def _resize_crop(images: torch.Tensor, y0, x0, ch, cw, out_size: int) -> torch.Tensor:
    """Resample each image's window [y0, y0+ch) x [x0, x0+cw) ((B,) tensors,
    pixels) to (out_size, out_size): ``_resize_crop`` (transforms.py:54-69),
    the separable antialiased linear weights of ``scale_and_translate``."""
    _, h, w, _ = images.shape
    wy = _weight_mat(h, out_size, out_size / ch, -y0 * out_size / ch)  # (B, H, S)
    wx = _weight_mat(w, out_size, out_size / cw, -x0 * out_size / cw)  # (B, W, S)
    with torch.autocast(images.device.type, enabled=False):
        x = torch.einsum("byxc,bys->bsxc", images.float(), wy)
        return torch.einsum("bsxc,bxt->bstc", x, wx)


def _crop_boxes(boxes_xyxy, valid, y0, x0, ch, cw, h: int, w: int):
    """Normalized xyxy boxes re-expressed in each pixel window, clipped to
    [0, 1]; boxes that collapse leave ``valid`` (transforms.py:72-81)."""
    x1, y1, x2, y2 = boxes_xyxy.float().unbind(-1)
    px = torch.stack([x1 * w, y1 * h, x2 * w, y2 * h], -1)
    shifted = px - torch.stack([x0, y0, x0, y0], -1)[:, None, :]
    rescaled = shifted / torch.stack([cw, ch, cw, ch], -1)[:, None, :]
    clipped = torch.clamp(rescaled, 0.0, 1.0)
    return clipped, valid & flat_box_mask(clipped)


def _flip_boxes(boxes_xyxy: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror normalized xyxy boxes horizontally where ``flip`` ((B,) bool)."""
    flipped = torch.stack(
        [1.0 - boxes_xyxy[..., 2], boxes_xyxy[..., 1], 1.0 - boxes_xyxy[..., 0], boxes_xyxy[..., 3]], -1
    )
    return torch.where(flip[:, None, None], flipped, boxes_xyxy)


def crop_flip(
    images: torch.Tensor,
    boxes_xyxy: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    area_frac: torch.Tensor,
    log_ratio: torch.Tensor,
    u_y: torch.Tensor,
    u_x: torch.Tensor,
    flip: torch.Tensor,
    out_size: int = 640,
    content_hw: Optional[torch.Tensor] = None,
) -> dict:
    """RandomResizedCrop + horizontal flip + normalize at given draws, one
    (B,) tensor each (transforms.py:117-173).

    The crop window is sampled from ``area_frac`` of the content and an
    aspect ``exp(log_ratio)``, its size clipped to [8, side], its offset
    ``u * (content side - crop)``; it is resampled to ``out_size`` with the
    antialiased linear kernel of ``jax.image.scale_and_translate``; boxes are
    re-expressed in the window, clipped to [0, 1], and those that collapse
    are dropped from ``valid``. The content is the whole canvas, or with
    ``content_hw`` ((B, 2) fractions of the canvas, from the letterbox
    loader) the top-left region the image fills: the crop's area and offsets
    are then taken inside it, though a window whose aspect does not fit may
    reach into the zero padding, and the output carries ``pixel_valid`` (B,
    S, S) bool, True where an output pixel samples content, flipped with the
    image.
    """
    b, h, w, _ = images.shape
    if content_hw is None:
        hc, wc = float(h), float(w)
    else:
        content = content_hw.to(device=images.device, dtype=torch.float32)
        hc, wc = content[:, 0] * h, content[:, 1] * w
    ratio = torch.exp(log_ratio)
    target_area = area_frac * hc * wc
    cw = torch.clamp(torch.sqrt(target_area * ratio), 8.0, float(w))
    ch = torch.clamp(torch.sqrt(target_area / ratio), 8.0, float(h))
    y0 = u_y * torch.clamp(hc - ch, min=0.0)
    x0 = u_x * torch.clamp(wc - cw, min=0.0)

    out = _resize_crop(images, y0, x0, ch, cw, out_size)
    new_boxes, new_valid = _crop_boxes(boxes_xyxy, valid, y0, x0, ch, cw, h, w)

    flip = flip.bool()
    out = torch.where(flip[:, None, None, None], out.flip(2), out)
    result = {"images": normalize_imagenet(out), "boxes": _flip_boxes(new_boxes, flip), "labels": labels,
              "valid": new_valid}
    if content_hw is not None:
        # output pixel (i, j) samples canvas position y0 + (i + 0.5) * ch / S
        centers = torch.arange(out_size, device=images.device, dtype=torch.float32) + 0.5
        rows = y0[:, None] + centers[None, :] * ch[:, None] / out_size
        cols = x0[:, None] + centers[None, :] * cw[:, None] / out_size
        pixel_valid = (rows[:, :, None] < hc[:, None, None]) & (cols[:, None, :] < wc[:, None, None])
        result["pixel_valid"] = torch.where(flip[:, None, None], pixel_valid.flip(2), pixel_valid)
    return result


def destr_train_transform(
    images: torch.Tensor,
    boxes_xyxy: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator,
    content_hw: Optional[torch.Tensor] = None,
    out_size: int = 640,
    scale_range: tuple = (0.08, 1.0),
    ratio_range: tuple = (3.0 / 4.0, 4.0 / 3.0),
) -> dict:
    """Batched RandomResizedCrop + hflip + normalize (transforms.py:84-173),
    its random draws from ``generator`` (on the images' device): per image
    the area fraction, log aspect, the two offsets and the flip. With the
    letterbox loader's ``content_hw`` the crop is taken over each image's
    content (:func:`crop_flip`). Returns {"images": (B, S, S, 3) float32,
    "boxes", "labels", "valid"}, and "pixel_valid" with ``content_hw``."""
    b = images.shape[0]
    u = torch.rand((5, b), generator=generator, device=images.device)
    lo_r, hi_r = math.log(ratio_range[0]), math.log(ratio_range[1])
    area_frac = scale_range[0] + (scale_range[1] - scale_range[0]) * u[0]
    log_ratio = lo_r + (hi_r - lo_r) * u[1]
    return crop_flip(images, boxes_xyxy, labels, valid, area_frac, log_ratio, u[2], u[3],
                     u[4] < 0.5, out_size, content_hw)
