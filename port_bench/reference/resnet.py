"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/models/resnet.py`` l.1-128, its kernels replaced by their plain versions and its data-parallel paths left out.]

ResNet backbone with frozen batch normalization (port of
``object_detection_destr_tpu/models/resnet.py``).

Takes NHWC images and returns NHWC stage maps like the JAX package; inside,
the convolutions run NCHW (the returned maps are permuted views). The JAX
package computes the 7x7/2 stem as an exact space-to-depth rewrite
(``SpaceToDepthStem``, resnet.py:58-103) for the TPU's matrix unit; here it is
the plain conv with the same ``(7, 7, 3, 64)`` parameter, carried across as
OIHW. Module names follow the flax ones (``conv1``, ``bn1``,
``layer{s}_{b}``, ``downsample_conv`` ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNet", "FrozenBatchNorm", "Bottleneck", "resnet50", "resnet101", "downsample_mask"]


class FrozenBatchNorm(nn.Module):
    """y = x * scale + shift with scale = weight / sqrt(var + eps) and
    shift = bias - mean * scale, folded in float32 and cast to the activation
    dtype (resnet.py:34-55). The four tensors are parameters initialized to
    identity, as they are flax params in the JAX package. They take no
    gradient until a trainer asks for one (train/state.py does: the
    global-norm clip counts their gradients), and the optimizer never
    updates them (train/optim.py labels them "frozen")."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.running_mean = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.running_var = nn.Parameter(torch.ones(features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W)."""
        scale = self.weight * (self.running_var + self.eps) ** -0.5
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with expansion 4 (resnet.py:106-145)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dilation: int = 1, project: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=strides, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(features * 4)
        self.project = project
        if project:
            self.downsample_conv = nn.Conv2d(in_features, features * 4, 1, stride=strides, bias=False)
            self.downsample_bn = FrozenBatchNorm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Multi-stage ResNet returning {"layer1".."layer4"} NHWC feature maps."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), dilation: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_features = 64
        widths = (64, 128, 256, 512)
        for stage, (blocks, width) in enumerate(zip(self.stage_sizes, widths)):
            dilate = dilation and stage == 3
            stride = 1 if stage == 0 or dilate else 2
            for blk in range(blocks):
                self.add_module(
                    f"layer{stage + 1}_{blk}",
                    Bottleneck(
                        in_features, width,
                        strides=stride if blk == 0 else 1,
                        dilation=2 if (dilate and blk > 0) else 1,
                        project=(blk == 0),
                    ),
                )
                in_features = width * 4

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, H, W, 3) -> {"layerN": (B, h, w, C)}."""
        y = x.permute(0, 3, 1, 2)
        y = F.relu(self.bn1(self.conv1(y)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)  # pads with -inf
        outputs = {}
        for stage, blocks in enumerate(self.stage_sizes):
            for blk in range(blocks):
                y = getattr(self, f"layer{stage + 1}_{blk}")(y)
            outputs[f"layer{stage + 1}"] = y.permute(0, 2, 3, 1)
        return outputs


def resnet50(dilation: bool = False) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), dilation=dilation)


def resnet101(dilation: bool = False) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), dilation=dilation)


def downsample_mask(valid_mask: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour downsample of a (B, H, W) bool mask with torch
    ``F.interpolate(mode='nearest')`` indexing, ``src = floor(dst * H / h)``
    (resnet.py:193-203)."""
    _, h_in, w_in = valid_mask.shape
    h_out, w_out = out_hw
    ri = (torch.arange(h_out, device=valid_mask.device) * h_in) // h_out
    ci = (torch.arange(w_out, device=valid_mask.device) * w_in) // w_out
    return valid_mask[:, ri][:, :, ci]
