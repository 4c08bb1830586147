"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/models/destr/mini_detector.py`` l.1-183, its kernels replaced by their plain versions and its data-parallel paths left out.]

DESTR mini-detector: dense per-token detection seeding the decoder queries
(port of ``object_detection_destr_tpu/models/destr/mini_detector.py``).

Three 4x(3x3 conv + BatchNorm) stacks. BatchNorm follows flax
(mini_detector.py:51-54): eps 1e-5; in eval it normalizes with the running
statistics (``running_mean`` / ``running_var`` here, flax's ``mean`` /
``var``); in training with the batch's float32 mean and biased variance
(E[x^2] - E[x]^2, clipped at 0), and it updates the running statistics with
flax's momentum 0.9 (torch's 0.1) and that same biased variance. With
``bn_axis_name`` set (flax ``BatchNorm(axis_name=...)``, JAX
mini_detector.py:51-54, model.py:103) the mean and the mean of squares are
pmeaned over the data-parallel mesh first, so every rank normalizes with
the global batch's statistics and keeps the same running ones; the three
stacks then run layer by layer, one pmean a layer for all three
(:func:`synced_stacks`), so that their backward all-reduces form one
chain. The
cls/bbox/pos heads are the model's shared modules, passed in at call time so
each has one set of parameters, and run in float32. The selected queries and
centres are detached, as the JAX package stop-gradients them
(mini_detector.py:119-121).
"""

from __future__ import annotations

import torch
from torch import nn

from .topk import masked_topk_with_recycle
from .layers import f32_head

__all__ = ["ConvBnStack", "MiniDetector", "batch_norm"]

BN_MOMENTUM = 0.9  # flax: new = momentum * running + (1 - momentum) * batch


def _normalize(x: torch.Tensor, xf: torch.Tensor, bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor,
               train: bool) -> torch.Tensor:
    """``xf`` (``x`` in float32) normalized with ``mean`` / ``var``, in
    ``x``'s dtype; in training the running statistics move towards them
    first (in place, without autograd)."""
    if train:
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            bn.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over NCHW ``x`` (statistics over N, H, W, and
    over the ranks of ``mesh``, a ``parallel.Mesh``, where one is given:
    :func:`synced_batch_norms`).

    In training the running statistics are updated in place (without
    autograd); the result is in ``x``'s dtype.
    """
    xf = x.float()
    if train:
        mean = xf.mean((0, 2, 3))
        var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
    else:
        mean, var = bn.running_mean, bn.running_var
    return _normalize(x, xf, bn, mean, var, train)


class ConvBnStack(nn.Module):
    """4x (3x3 same conv + BatchNorm), no activation (mini_detector.py:36-55).
    NHWC in and out; the convs run NCHW."""

    def __init__(self, hidden_dim: int = 256, num_layers: int = 4):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"conv{i}", nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1))
            self.add_module(f"bn{i}", nn.BatchNorm2d(hidden_dim, eps=1e-5))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_layers):
            x = batch_norm(getattr(self, f"conv{i}")(x), getattr(self, f"bn{i}"), train)
        return x.permute(0, 2, 3, 1)


class MiniDetector(nn.Module):
    """Returns (selected_objects (B, k, 2C), selected_centers (B, k, 2),
    det_output {"pred_class": (B, HW, num_cls), "pred_boxes": (B, HW, 4)})
    (mini_detector.py:79-123)."""

    def __init__(self, top_k: int, hidden_dim: int = 256):
        super().__init__()
        self.top_k = top_k
        self.cls_conv = ConvBnStack(hidden_dim)
        self.pos_conv = ConvBnStack(hidden_dim)
        self.reg_conv = ConvBnStack(hidden_dim)

    def forward(self, features, fine_pos, valid_mask, cls_embed, bbox_embed, pos_head,
                train: bool = False):
        """features/fine_pos: (B, H, W, C); valid_mask: (B, H, W) bool."""
        b, h, w, c = features.shape
        flat_valid = valid_mask.reshape(b, h * w)[..., None]

        def mask_tokens(t):
            return torch.where(flat_valid, t.reshape(b, h * w, c), 0.0)

        stacks, inputs = (self.cls_conv, self.pos_conv, self.reg_conv), (features, fine_pos, features)

        def stack(i):
            return stacks[i](inputs[i], train)

        cls_feats = mask_tokens(stack(0))
        det_class = f32_head(cls_embed, cls_feats)  # (B, HW, num_cls) logits
        pos_feats = mask_tokens(stack(1))
        center_offset = f32_head(pos_head, pos_feats)  # (B, HW, 2)
        reg_feats = mask_tokens(stack(2))
        bbox = f32_head(bbox_embed, reg_feats)  # (B, HW, 4)
        bbox = torch.cat([bbox[..., :2] + center_offset, bbox[..., 2:]], dim=-1)
        det_boxes = torch.sigmoid(bbox)
        det_output = {"pred_class": det_class, "pred_boxes": det_boxes}

        # query selection: max sigmoid class score over valid tokens
        scores = torch.sigmoid(det_class).amax(dim=-1)
        k = min(self.top_k, h * w)
        topk_idx = masked_topk_with_recycle(scores.detach(), k, flat_valid[..., 0])  # (B, k)

        object_feats = torch.cat([cls_feats, reg_feats], dim=-1).detach()  # (B, HW, 2C)
        selected_objects = torch.gather(
            object_feats, 1, topk_idx[..., None].expand(b, k, 2 * c)
        )
        centers = torch.where(flat_valid, det_boxes, 0.0)[..., :2].detach()
        selected_centers = torch.gather(centers, 1, topk_idx[..., None].expand(b, k, 2))
        return selected_objects, selected_centers, det_output
