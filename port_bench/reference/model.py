"""[Benchmark reference: a frozen copy of ``object_detection_destr_tpu_torch/models/destr/model.py`` l.1-147, its kernels replaced by their plain versions and its data-parallel paths left out.]

DESTR top-level model: backbone -> encoder -> mini-detector -> split decoder
(port of ``object_detection_destr_tpu/models/destr/model.py``).

Forward contract (model.py:107-178):
    inputs: images (B, H, W, 3) float32, optional valid_mask (B, H, W) bool.
    returns: ({"pred_class": (B, k, num_cls), "pred_boxes": (B, k, 4)},
              {"pred_class": (B, HW, num_cls), "pred_boxes": (B, HW, 4)})
    boxes are cxcyhw in [0, 1]; class entries are raw logits.

The shared heads ``cls_embed``, ``bbox_embed`` and ``pos_head`` are modules of
this model, passed to the mini-detector and the decoder at call time, so each
has one set of parameters as in flax, and run in float32.

``compute_dtype="bfloat16"`` runs the backbone, the transformer and the
mini-detector under ``torch.autocast(bfloat16)`` (convolutions, linears and
the flash kernels in bfloat16, normalizations in float32), the shared heads
in float32 and the outputs in float32, as model.py:50-53, 118-119, 173-177
of the JAX package. ``train=True`` (or ``model.train()``) uses batch
statistics in the mini-detector's BatchNorm and, with a
:class:`~.layers.DropoutRng`, dropout at the JAX package's sites.
``remat=True`` recomputes each encoder and decoder block's activations in
the backward (``nn.remat`` in the JAX package), with the forward's dropout
draws (:func:`~.layers.checkpointed`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .embeddings import inverse_sigmoid, sine_embed_centers, sine_position_map
from .resnet import downsample_mask, resnet50, resnet101
from .decoder import Decoder
from .encoder import Encoder
from .layers import DropoutRng, LearnedPositionEmbedding, Mlp, autocast, f32_head
from .mini_detector import MiniDetector

__all__ = ["DESTR", "build_destr"]


class DESTR(nn.Module):
    def __init__(self, config):
        super().__init__()
        cfg = self.config = config
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r}")
        if cfg.use_flash_attention not in ("auto", True, False):
            raise ValueError(f"use_flash_attention={cfg.use_flash_attention!r}")
        use_flash = cfg.use_flash_attention is not False
        c = cfg.hidden_dim
        if cfg.backbone == "resnet50":
            self.backbone = resnet50(cfg.dilation)
        elif cfg.backbone == "resnet101":
            self.backbone = resnet101(cfg.dilation)
        else:
            raise ValueError(f"unknown backbone {cfg.backbone}")

        self.cls_embed = nn.Linear(c, cfg.num_cls)
        self.bbox_embed = Mlp(c, [c, 4])
        self.pos_head = Mlp(c, [c, c, 2])  # the reference's `reg_ffn`
        self.reduce_dim = nn.Conv2d(2048, c, 1)
        if cfg.pos_embed == "learned":
            self.pos_embedding = LearnedPositionEmbedding(num_pos_feats=c // 2)
        self.encoder = Encoder(c, cfg.num_heads, cfg.ffn_dim, cfg.num_encoder_blocks, use_flash,
                               cfg.dropout, cfg.remat)
        self.decoder = Decoder(
            c, cfg.num_heads, cfg.num_decoder_blocks, cfg.lambda_pair,
            cfg.pair_mode, cfg.pair_output_mode, use_flash, cfg.dropout, cfg.remat,
        )
        self.mini_detector = MiniDetector(cfg.top_k, c)

    def forward(
        self,
        images: torch.Tensor,
        valid_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        rng: Optional[DropoutRng] = None,
    ):
        """``rng`` drives dropout in training; without it dropout is off."""
        train = train or self.training
        if not train:
            rng = None
        # cache_enabled=False: no cast cache across calls, which a CUDA graph
        # capture of the forward would otherwise hold on to
        with autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.config.compute_dtype == "bfloat16", cache_enabled=False):
            model_output, det_output = self._forward(images, valid_mask, train, rng)
        return (
            {k: v.float() for k, v in model_output.items()},
            {k: v.float() for k, v in det_output.items()},
        )

    def _forward(self, images, valid_mask, train, rng):
        cfg = self.config
        c = cfg.hidden_dim
        b, h_img, w_img, _ = images.shape
        if valid_mask is None:
            valid_mask = torch.ones((b, h_img, w_img), dtype=torch.bool, device=images.device)

        c5 = self.backbone(images.float())["layer4"]  # (B, H/32, W/32, 2048)
        _, h, w, _ = c5.shape
        c5_valid = downsample_mask(valid_mask, (h, w))
        x_map = self.reduce_dim(c5.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # (B, h, w, C)

        if cfg.pos_embed == "learned":
            pos_map = self.pos_embedding(h, w)[None].expand(b, h, w, c)
        else:
            pos_map = sine_position_map(c5_valid, num_pos_feats=c // 2)
        pos_map = pos_map.to(x_map.dtype)

        # row-major (h, w) token order, as x_map.reshape at model.py:136
        tokens = x_map.reshape(b, h * w, c)
        pos_tokens = pos_map.reshape(b, h * w, c)
        flat_valid = c5_valid.reshape(b, h * w)

        enc_tokens = self.encoder(tokens, pos_tokens, flat_valid, rng)
        # fine positional embedding: pos * encoder.pos_scale(encoder output)
        fine_pos = pos_tokens * self.encoder.pos_scale(enc_tokens)

        selected_objects, selected_centers, det_output = self.mini_detector(
            enc_tokens.reshape(b, h, w, c), fine_pos.reshape(b, h, w, c), c5_valid,
            self.cls_embed, self.bbox_embed, self.pos_head, train,
        )
        obj_pos_embed = sine_embed_centers(selected_centers, d_model=c).to(x_map.dtype)

        x = self.decoder(
            selected_objects, enc_tokens, flat_valid, fine_pos, obj_pos_embed,
            selected_centers, self.bbox_embed, rng,
        )
        cls_output = f32_head(self.cls_embed, x[..., :c])
        tmp = f32_head(self.bbox_embed, x[..., c:])
        tmp = torch.cat([tmp[..., :2] + inverse_sigmoid(selected_centers), tmp[..., 2:]], dim=-1)
        model_output = {"pred_class": cls_output, "pred_boxes": torch.sigmoid(tmp)}
        return model_output, det_output
