"""SSD300: a VGG-16 trunk, five extra blocks and per-scale conv heads (port of
``object_detection_destr_tpu/models/ssd/model.py``, l.1-110).

Forward contract (model.py:73-105):
    inputs: images (B, H, W, 3) float32, NHWC.
    returns: {"boxes": [6 x (B, Hs, Ws, A, 4)],
              "conf":  [6 x (B, Hs, Ws, A, num_cls + 1)]} in float32,
    the background class last (channel ``num_cls``).

Module names are flax's (``backbone.conv0..9``, ``extra{i}.conv1/bn1/conv2/
bn2``, ``box_head{i}``, ``conf_head{i}``), so ``models/convert.py`` carries
flax variables over by name. The convolutions run NCHW on a permuted view of
the NHWC input. What keeps the numbers the JAX package's:

* flax ``padding="SAME"`` with stride 2 pads ``total = max((ceil(n / 2) - 1)
  * 2 + 3 - n, 0)`` split low ``total // 2``, high the rest: (1, 1) at 37 and
  19, but (0, 1) at 10, where ``Conv2d(padding=1)`` would give the right size
  on a window shifted by one pixel; so the pad is explicit (:func:`_same_pad`);
* the VGG max-pools are 2x2, stride 2, floor mode, unpadded;
* the extra blocks' BatchNorm is flax's (momentum 0.9, biased variance, eps
  1e-5, statistics in float32: ``mini_detector.batch_norm``);
* ``compute_dtype="bfloat16"`` runs the trunk and the extra blocks under
  ``torch.autocast(bfloat16)``; the heads run outside it on a float32 copy of
  their input, as flax computes a float32-parameter conv on a bf16 input in
  float32 (model.py:99-103);
* a head's NCHW output is permuted to NHWC before the (A, ·) reshape, as flax
  reshapes (B, H, W, A·k).

The parameters start from flax's initialisers (kernels lecun-normal,
truncated at two standard deviations; biases 0; BatchNorm 1 and 0), so a run
from scratch starts from the JAX package's distribution.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...config import SSDConfig, resolve_device
from ..destr.layers import f32_head
from ..destr.mini_detector import batch_norm, sync_batch_norms

__all__ = ["SSD", "ExtraBlock", "VGG16Features", "build_ssd"]

_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)
# flax's lecun_normal: a standard normal truncated at +-2, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _same_pad(n: int, kernel: int = 3, stride: int = 2) -> tuple[int, int]:
    """flax / XLA ``SAME`` padding (low, high) of one spatial axis of size ``n``."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class VGG16Features(nn.Module):
    """VGG-16 through conv4_3 + ReLU (torchvision ``features[:23]``): ten 3x3
    convs ``conv0..conv9`` and three floor-mode 2x2 max-pools. NCHW."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for v in _VGG_CFG:
            if v != "M":
                self.add_module(f"conv{len(layers)}", nn.Conv2d(in_ch, v, 3, padding=1))
                layers.append(v)
                in_ch = v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_i = 0
        for v in _VGG_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv{conv_i}")(x))
                conv_i += 1
        return x  # (B, 512, H/8, W/8)


class ExtraBlock(nn.Module):
    """1x1 reduce + 3x3 conv (stride 2 SAME, or stride 1 VALID), each
    conv-BN-ReLU, bias-free (model.py:49-70). NCHW."""

    def __init__(self, in_ch: int, mid: int, out: int, stride2: bool):
        super().__init__()
        self.stride2 = stride2
        self.conv1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid, eps=1e-5)
        self.conv2 = nn.Conv2d(mid, out, 3, stride=2 if stride2 else 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out, eps=1e-5)
        self.bn_mesh = None  # the mesh the statistics sync over (sync_batch_norms)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(batch_norm(self.conv1(x), self.bn1, train, self.bn_mesh))
        if self.stride2:
            (hl, hh), (wl, wh) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.pad(x, (wl, wh, hl, hh))
        return F.relu(batch_norm(self.conv2(x), self.bn2, train, self.bn_mesh))


class SSD(nn.Module):
    def __init__(self, config: SSDConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r}")
        self.num_conf = cfg.num_cls + 1  # + background, counted once
        self.backbone = VGG16Features()
        channels = [512]
        dims = [(1024, 1024), (256, 512), (128, 256), (128, 256), (128, 256)]
        for i, (mid, out) in enumerate(dims):
            self.add_module(f"extra{i}", ExtraBlock(channels[-1], mid, out, stride2=i < 3))
            channels.append(out)
        for i, (ch, num_a) in enumerate(zip(channels, cfg.anchors_per_scale)):
            self.add_module(f"box_head{i}", nn.Conv2d(ch, num_a * 4, 3, padding=1))
            self.add_module(f"conf_head{i}", nn.Conv2d(ch, num_a * self.num_conf, 3, padding=1))
        self._init_like_flax()

    @torch.no_grad()
    def _init_like_flax(self) -> None:
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                std = math.sqrt(1.0 / (module.weight[0].numel())) / _TRUNC_STD
                nn.init.trunc_normal_(module.weight, std=std, a=-2.0 * std, b=2.0 * std)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def forward(self, images: torch.Tensor, train: bool = False) -> dict[str, list[torch.Tensor]]:
        """``train`` (or ``model.train()``) normalizes the extra blocks with
        the batch's statistics and updates the running ones."""
        train = train or self.training
        # cache_enabled=False: no cast cache a CUDA graph capture would hold on to
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.config.compute_dtype == "bfloat16", cache_enabled=False):
            x = self.backbone(images.float().permute(0, 3, 1, 2))
            features = [x]
            for i in range(5):
                x = getattr(self, f"extra{i}")(x, train)
                features.append(x)
        outputs: dict[str, list[torch.Tensor]] = {"boxes": [], "conf": []}
        for i, (ft, num_a) in enumerate(zip(features, self.config.anchors_per_scale)):
            b, _, h, w = ft.shape
            box = f32_head(getattr(self, f"box_head{i}"), ft).permute(0, 2, 3, 1)
            conf = f32_head(getattr(self, f"conf_head{i}"), ft).permute(0, 2, 3, 1)
            outputs["boxes"].append(box.reshape(b, h, w, num_a, 4))
            outputs["conf"].append(conf.reshape(b, h, w, num_a, self.num_conf))
        return outputs


def build_ssd(config: SSDConfig | None = None, device: str | torch.device | None = None, mesh=None) -> SSD:
    """The model in eval mode on ``device`` (the GPU unless ``"cpu"`` is asked
    for; with no CUDA device and no explicit CPU this raises). With the
    config's ``bn_axis_name`` the extra blocks' BatchNorms sync over
    ``mesh`` (``mini_detector.sync_batch_norms``)."""
    config = config or SSDConfig()
    return sync_batch_norms(SSD(config).to(resolve_device(device)).eval(), config.bn_axis_name, mesh)
