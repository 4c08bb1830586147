"""Transforms as batched tensor ops on the images' device (port of
``object_detection_destr_tpu/data/transforms.py``: ``normalize_imagenet``
l.47-51, ``destr_train_transform`` l.54-173, ``destr_eval_transform``
l.176-219, ``letterbox_infer_transform`` l.222-245, ``ssd_train_transform``
l.248-338, ``ssd_eval_transform`` l.341-359).

A random transform is split into its draws, made from a ``torch.Generator``
on the images' device, and a pure function of them (``crop_flip``,
``ssd_patch_flip``), which the tests feed the JAX package's draws.
Constants enter the ops as Python scalars: nothing is copied from the host,
so a CUDA graph can capture a transform."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.boxes import flat_box_mask, xyxy_to_cxcyhw

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "crop_flip",
    "destr_eval_transform",
    "destr_train_transform",
    "letterbox_infer_transform",
    "normalize_imagenet",
    "ssd_eval_transform",
    "ssd_patch_flip",
    "ssd_train_transform",
]

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


def _drawn_rows(draw, b: int, mesh, axis: int = 0) -> torch.Tensor:
    """``draw(n)`` for this rank's ``b`` images: the whole global batch's
    draws (``b`` times the mesh's size) cut to the rank's rows on ``axis``;
    ``draw(b)`` without a mesh."""
    if mesh is None:
        return draw(b)
    drawn = draw(b * mesh.size)
    return drawn.narrow(axis, mesh.rank * b, b)


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
    mesh=None,
) -> dict:
    """Batched RandomResizedCrop + hflip + normalize (transforms.py:84-173),
    its random draws from ``generator`` (on the images' device): per image
    the area fraction, log aspect, the two offsets and the flip. With the
    letterbox loader's ``content_hw`` the crop is taken over each image's
    content (:func:`crop_flip`). Returns {"images": (B, S, S, 3) float32,
    "boxes", "labels", "valid"}, and "pixel_valid" with ``content_hw``.

    With a data-parallel ``mesh`` the batch is this rank's rows of the
    global batch: the draws are the global batch's, and the rank keeps its
    columns, as the JAX driver augments the sharded global batch with one
    key (driver.py:200-216), so N ranks draw what one process draws."""
    b = images.shape[0]
    u = _drawn_rows(lambda n: torch.rand((5, n), generator=generator, device=images.device), b, mesh, axis=1)
    lo_r, hi_r = math.log(ratio_range[0]), math.log(ratio_range[1])
    area_frac = scale_range[0] + (scale_range[1] - scale_range[0]) * u[0]
    log_ratio = lo_r + (hi_r - lo_r) * u[1]
    return crop_flip(images, boxes_xyxy, labels, valid, area_frac, log_ratio, u[2], u[3],
                     u[4] < 0.5, out_size, content_hw)


def destr_eval_transform(
    images: torch.Tensor,
    boxes_xyxy: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    content_hw: Optional[torch.Tensor] = None,
    resize_to: int = 672,
    out_size: int = 640,
) -> dict:
    """Resize shorter-side-to-``resize_to`` + center-crop ``out_size``
    (transforms.py:176-219): per image the centred square window of side
    ``out_size / resize_to * min(hc, wc)`` over the content (the letterbox
    loader's ``content_hw`` fractions; the whole canvas without them),
    resampled to ``out_size``, boxes re-expressed in it. The window lies
    inside the content, so no pixel mask is needed. Returns {"images": (B, S,
    S, 3) normalized float32, "boxes", "labels", "valid"}."""
    b, h, w, _ = images.shape
    if content_hw is None:
        content_hw = torch.ones((b, 2), dtype=torch.float32, device=images.device)
    content = content_hw.to(device=images.device, dtype=torch.float32)
    hc, wc = content[:, 0] * h, content[:, 1] * w
    side = torch.minimum(hc, wc) * out_size / resize_to
    y0, x0 = (hc - side) / 2.0, (wc - side) / 2.0
    out = _resize_crop(images, y0, x0, side, side, out_size)
    new_boxes, new_valid = _crop_boxes(boxes_xyxy, valid, y0, x0, side, side, h, w)
    return {"images": normalize_imagenet(out), "boxes": new_boxes, "labels": labels, "valid": new_valid}


# the retention modes, the least share of valid box centres a crop must
# keep, -1 for "keep the whole image" (transforms.py:248-250; the
# reference's {None, 0, .1, .3, .5, .7, .9})
SSD_MODES = (-1.0, 0.0, 0.1, 0.3, 0.5, 0.7, 0.9)


def ssd_patch_flip(
    images: torch.Tensor,
    boxes_xyxy: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    mode_idx: torch.Tensor,
    dims: torch.Tensor,
    pos: torch.Tensor,
    flip: torch.Tensor,
    out_size: int = 300,
) -> dict:
    """SSD random patch + resize + horizontal flip + normalize at given draws
    (transforms.py:264-330): per image ``mode_idx`` (B,) into
    :data:`SSD_MODES`, ``dims`` (B, K, 2) each candidate crop's (h, w)
    fraction in [0.3, 1], ``pos`` (B, K, 2) its (y, x) offset fraction of the
    room left, ``flip`` (B,) bool.

    A candidate is admissible when the share of valid box centres inside it
    is at least the mode; the first admissible one is the crop, or the whole
    image where none is or the mode is -1. Boxes are re-expressed in the crop
    and clipped; a box leaves ``valid`` when it collapses or its centre lies
    outside the crop. Returns {"images": (B, S, S, 3) normalized float32,
    "boxes": (B, T, 4) cxcyhw, "labels", "valid"}."""
    b, h, w, _ = images.shape
    mode = torch.full(mode_idx.shape, SSD_MODES[0], dtype=torch.float32, device=images.device)
    for k, v in enumerate(SSD_MODES[1:], 1):
        mode = torch.where(mode_idx == k, v, mode)
    chs, cws = dims[..., 0] * h, dims[..., 1] * w  # (B, K)
    y0s, x0s = pos[..., 0] * (h - chs), pos[..., 1] * (w - cws)

    boxes = boxes_xyxy.float()
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0 * w  # (B, T) pixel centres
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0 * h
    inside = (
        (cx[:, None, :] >= x0s[..., None]) & (cx[:, None, :] < (x0s + cws)[..., None])
        & (cy[:, None, :] >= y0s[..., None]) & (cy[:, None, :] < (y0s + chs)[..., None])
        & valid[:, None, :]
    )  # (B, K, T)
    n_valid = torch.clamp(valid.sum(-1), min=1)  # (B,)
    frac = inside.sum(-1) / n_valid[:, None]  # (B, K)
    admissible = frac >= torch.clamp(mode, min=0.0)[:, None]
    pick = admissible.to(torch.uint8).argmax(-1)  # the first admissible
    any_ok = admissible.any(-1) & ~(mode < 0.0)

    take = lambda t: t.gather(1, pick[:, None])[:, 0]
    y0 = torch.where(any_ok, take(y0s), 0.0)
    x0 = torch.where(any_ok, take(x0s), 0.0)
    ch = torch.where(any_ok, take(chs), float(h))
    cw = torch.where(any_ok, take(cws), float(w))

    out = _resize_crop(images, y0, x0, ch, cw, out_size)
    new_boxes, new_valid = _crop_boxes(boxes_xyxy, valid, y0, x0, ch, cw, h, w)
    kept = inside.gather(1, pick[:, None, None].expand(b, 1, inside.shape[-1]))[:, 0]
    new_valid = new_valid & torch.where(any_ok[:, None], kept, valid)

    flip = flip.bool()
    out = torch.where(flip[:, None, None, None], out.flip(2), out)
    return {"images": normalize_imagenet(out), "boxes": xyxy_to_cxcyhw(_flip_boxes(new_boxes, flip)),
            "labels": labels, "valid": new_valid}


def ssd_train_transform(
    images: torch.Tensor,
    boxes_xyxy: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator,
    out_size: int = 300,
    num_candidates: int = 8,
    mesh=None,
) -> dict:
    """:func:`ssd_patch_flip` at draws from ``generator`` (on the images'
    device): per image a mode, ``num_candidates`` crop sizes in [0.3, 1] and
    offsets in [0, 1), and a flip (transforms.py:248-338). With a ``mesh``,
    the global batch's draws and this rank's rows of them
    (:func:`destr_train_transform`)."""
    b, dev = images.shape[0], images.device
    k = num_candidates
    mode_idx = _drawn_rows(lambda n: torch.randint(0, len(SSD_MODES), (n,), generator=generator, device=dev),
                           b, mesh)
    dims = 0.3 + 0.7 * _drawn_rows(lambda n: torch.rand((n, k, 2), generator=generator, device=dev), b, mesh)
    pos = _drawn_rows(lambda n: torch.rand((n, k, 2), generator=generator, device=dev), b, mesh)
    flip = _drawn_rows(lambda n: torch.rand((n,), generator=generator, device=dev), b, mesh) < 0.5
    return ssd_patch_flip(images, boxes_xyxy, labels, valid, mode_idx, dims, pos, flip, out_size)


def ssd_eval_transform(
    images: torch.Tensor,
    boxes_xyxy: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    out_size: int = 300,
) -> dict:
    """Stretch the whole canvas to ``out_size`` (no letterbox) + normalize;
    boxes to cxcyhw, collapsed ones out of ``valid`` (transforms.py:341-359)."""
    b, h, w, _ = images.shape
    zero = torch.zeros((b,), dtype=torch.float32, device=images.device)
    out = _resize_crop(images, zero, zero, zero + h, zero + w, out_size)
    return {"images": normalize_imagenet(out), "boxes": xyxy_to_cxcyhw(boxes_xyxy.float()), "labels": labels,
            "valid": valid & flat_box_mask(boxes_xyxy)}
