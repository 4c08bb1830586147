"""Torch state dicts in the reference's key layout, written from a flax
variables tree: the inverse of the ``*_from_torch`` importers of both
packages' ``models/convert.py``.

Numpy only; it imports neither package, so the tests of both and
``chip_smoke.py`` can use it. Conv kernels go from HWIO to OIHW, Dense
kernels from ``(in, out)`` to ``(out, in)``, LayerNorm and BatchNorm
``scale`` to ``weight``, BatchNorm ``mean`` / ``var`` to ``running_mean`` /
``running_var``. What the reference carries and the importers drop is
written too: torchvision's ``fc`` head, and the SSD confidence heads' dead
channel ``num_cls`` of each anchor (REFCOMPAT #4). The DESTR mini-detector's
reg- and pos-stack BatchNorms go where the reference keeps them, at
``_cls_conv.8..11`` and ``_cls_conv.12..15`` (REFCOMPAT #1).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

__all__ = [
    "torchvision_resnet_state_dict",
    "torchvision_vgg16_state_dict",
    "reference_encoder_state_dict",
    "reference_decoder_state_dict",
    "reference_destr_state_dict",
    "reference_ssd_state_dict",
]

_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)  # conv layers of vgg16().features[:23]
_DEAD_CHANNEL = -1e3  # the value written into the confidence heads' dead channel


def _oihw(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1))


def _linear(tree: Mapping, prefix: str) -> dict:
    out = {f"{prefix}.weight": np.ascontiguousarray(np.asarray(tree["kernel"]).T)}
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])
    return out


def _conv(tree: Mapping, prefix: str) -> dict:
    out = {f"{prefix}.weight": _oihw(tree["kernel"])}
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])
    return out


def _layernorm(tree: Mapping, prefix: str) -> dict:
    return {f"{prefix}.weight": np.asarray(tree["scale"]), f"{prefix}.bias": np.asarray(tree["bias"])}


def _batchnorm(params: Mapping, stats: Mapping, prefix: str) -> dict:
    return {f"{prefix}.weight": np.asarray(params["scale"]), f"{prefix}.bias": np.asarray(params["bias"]),
            f"{prefix}.running_mean": np.asarray(stats["mean"]), f"{prefix}.running_var": np.asarray(stats["var"])}


def _frozen_bn(tree: Mapping, prefix: str) -> dict:
    return {f"{prefix}.{k}": np.asarray(tree[k]) for k in ("weight", "bias", "running_mean", "running_var")}


def _with_prefix(sd: Mapping, prefix: str) -> dict:
    return {prefix + k: v for k, v in sd.items()}


def torchvision_resnet_state_dict(backbone: Mapping) -> dict:
    """torchvision ResNet keys (``conv1``, ``bn1``, ``layerS.I.convJ`` /
    ``bnJ`` / ``downsample.{0,1}``, and an ``fc`` head of zeros) from the
    ``params["backbone"]`` tree of ``models/resnet.py``."""
    sd = {**_conv(backbone["conv1"], "conv1"), **_frozen_bn(backbone["bn1"], "bn1")}
    for scope, block in backbone.items():
        if not scope.startswith("layer"):
            continue
        stage, index = scope[len("layer"):].split("_")
        tp = f"layer{stage}.{index}"
        for j in (1, 2, 3):
            sd.update(_conv(block[f"conv{j}"], f"{tp}.conv{j}"))
            sd.update(_frozen_bn(block[f"bn{j}"], f"{tp}.bn{j}"))
        if "downsample_conv" in block:
            sd.update(_conv(block["downsample_conv"], f"{tp}.downsample.0"))
            sd.update(_frozen_bn(block["downsample_bn"], f"{tp}.downsample.1"))
    sd["fc.weight"] = np.zeros((1000, 2048), np.float32)
    sd["fc.bias"] = np.zeros((1000,), np.float32)
    return sd


def torchvision_vgg16_state_dict(backbone: Mapping, prefix: str = "features.") -> dict:
    """``vgg16().features`` keys (``features.0`` ... ``features.21``, or
    bare indices with ``prefix=""``) from the SSD ``params["backbone"]`` tree."""
    sd = {}
    for ours, theirs in enumerate(_VGG16_CONV_IDX):
        sd.update(_conv(backbone[f"conv{ours}"], f"{prefix}{theirs}"))
    return sd


def reference_encoder_state_dict(encoder: Mapping) -> dict:
    """The reference ``Encoder``'s keys from ``params["encoder"]``: q / k / v
    packed row-wise into ``self_attn.in_proj_weight`` / ``in_proj_bias``."""
    sd = {**_linear(encoder["pos_scale"]["fc0"], "_pos_scale.0"),
          **_linear(encoder["pos_scale"]["fc1"], "_pos_scale.2"),
          **_layernorm(encoder["outer_norm"], "norm")}
    blocks = sorted((k for k in encoder if k.startswith("block")), key=lambda k: int(k[len("block"):]))
    for name in blocks:
        block, tp = encoder[name], f"_encoder.{name[len('block'):]}"
        attn = block["self_attn"]
        sd[f"{tp}.self_attn.in_proj_weight"] = np.concatenate(
            [np.asarray(attn[p]["kernel"]).T for p in ("q_proj", "k_proj", "v_proj")])
        sd[f"{tp}.self_attn.in_proj_bias"] = np.concatenate(
            [np.asarray(attn[p]["bias"]) for p in ("q_proj", "k_proj", "v_proj")])
        sd.update(_linear(attn["out_proj"], f"{tp}.self_attn.out_proj"))
        for part in ("fc1", "fc2"):
            sd.update(_linear(block[part], f"{tp}.{part}"))
        for part in ("norm1", "norm2"):
            sd.update(_layernorm(block[part], f"{tp}.{part}"))
    return sd


_DECODER_PROJ = {
    "sa_q_obj": "_sa_proj_to_q_obj", "sa_q_pos": "_sa_proj_to_q_pos", "sa_k_obj": "_sa_proj_to_k_obj",
    "sa_k_pos": "_sa_proj_to_k_pos", "sa_v_obj": "_sa_proj_to_v_obj", "ca_q_obj": "_ca_proj_to_q_obj",
    "ca_q_pos": "_ca_proj_to_q_pos", "ca_k_enc": "_ca_proj_to_k_enc", "ca_k_pos": "_ca_proj_to_k_pos",
    "ca_v_enc": "_ca_proj_to_v_enc",
}


def reference_decoder_state_dict(decoder: Mapping) -> dict:
    """The reference ``Decoder``'s keys from ``params["decoder"]``."""
    sd = {**_linear(decoder["pos_scale"]["fc0"], "_pos_scale.0"),
          **_linear(decoder["pos_scale"]["fc1"], "_pos_scale.2"),
          **_layernorm(decoder["outer_norm"], "norm")}
    blocks = sorted((k for k in decoder if k.startswith("block")), key=lambda k: int(k[len("block"):]))
    for name in blocks:
        block, tp = decoder[name], f"_decoder.{name[len('block'):]}"
        for ours, theirs in _DECODER_PROJ.items():
            sd.update(_linear(block[ours], f"{tp}.{theirs}"))
        for part in ("norm1", "norm2"):
            sd.update(_layernorm(block[part], f"{tp}.{part}"))
        for ours, theirs in (("cls_branch", "_cls_branch"), ("reg_branch", "_reg_branch")):
            for part in ("fc1", "fc2"):
                sd.update(_linear(block[ours][part], f"{tp}.{theirs}.{part}"))
            for part in ("norm1", "norm2"):
                sd.update(_layernorm(block[ours][part], f"{tp}.{theirs}.{part}"))
    return sd


def reference_destr_state_dict(variables: Mapping) -> dict:
    """A whole reference ``ObjDetSplitTransformer`` state dict from DESTR's
    flax ``{"params", "batch_stats"}``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {
        **_with_prefix(torchvision_resnet_state_dict(params["backbone"]), "_backbone.0.body."),
        **_with_prefix(reference_encoder_state_dict(params["encoder"]), "_encoder."),
        **_with_prefix(reference_decoder_state_dict(params["decoder"]), "_decoder."),
        **_linear(params["cls_embed"], "_cls_embed"),
        **_linear(params["bbox_embed"]["fc0"], "_bbox_embed.0"),
        **_linear(params["bbox_embed"]["fc1"], "_bbox_embed.2"),
        **_conv(params["reduce_dim"], "_reduce_dim"),
    }
    for ours, theirs in (("fc0", "0"), ("fc1", "2"), ("fc2", "4")):
        sd.update(_linear(params["pos_head"][ours], f"_reg_ffn.{theirs}"))
    md, mp, ms = "_mini_detector", params["mini_detector"], stats["mini_detector"]
    # (our stack, its conv's key, the index in _cls_conv of its BatchNorm)
    stacks = (("cls_conv", lambda i: f"_cls_conv.{2 * i}", lambda i: 2 * i + 1),
              ("reg_conv", lambda i: f"_reg_conv.{i}", lambda i: 8 + i),
              ("pos_conv", lambda i: f"_pos_conv.{i}", lambda i: 12 + i))
    for ours, conv, bn in stacks:
        for i in range(4):
            sd.update(_conv(mp[ours][f"conv{i}"], f"{md}.{conv(i)}"))
            sd.update(_batchnorm(mp[ours][f"bn{i}"], ms[ours][f"bn{i}"], f"{md}._cls_conv.{bn(i)}"))
    return sd


def reference_ssd_state_dict(variables: Mapping, num_cls: int = 20,
                             anchors: tuple = (4, 6, 6, 6, 4, 4)) -> dict:
    """A whole reference ``SingleShotDetector`` state dict from SSD's flax
    ``{"params", "batch_stats"}``: ``A * (num_cls + 2)`` confidence channels
    a scale, the dead channel ``num_cls`` of each anchor set to a constant."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = torchvision_vgg16_state_dict(params["backbone"], prefix="_backbone._layers.")
    for i in range(5):
        tp, p, s = f"_feature_maps.{i}", params[f"extra{i}"], stats[f"extra{i}"]
        sd.update(_conv(p["conv1"], f"{tp}.0"))
        sd.update(_batchnorm(p["bn1"], s["bn1"], f"{tp}.1"))
        sd.update(_conv(p["conv2"], f"{tp}.3"))
        sd.update(_batchnorm(p["bn2"], s["bn2"], f"{tp}.4"))
    for i, a in enumerate(anchors):
        sd.update(_conv(params[f"box_head{i}"], f"_detectors.boxes.{i}"))
        w = np.asarray(params[f"conf_head{i}"]["kernel"])  # (3, 3, in, A * (num_cls + 1))
        b = np.asarray(params[f"conf_head{i}"]["bias"])
        cin = w.shape[2]
        w = w.reshape(3, 3, cin, a, num_cls + 1)
        b = b.reshape(a, num_cls + 1)
        # per anchor: the classes, the dead channel, then the background
        w = np.concatenate([w[..., :num_cls], np.full(w.shape[:-1] + (1,), _DEAD_CHANNEL, w.dtype),
                            w[..., num_cls:]], axis=-1)
        b = np.concatenate([b[:, :num_cls], np.full((a, 1), _DEAD_CHANNEL, b.dtype), b[:, num_cls:]], axis=-1)
        sd[f"_detectors.conf.{i}.weight"] = _oihw(w.reshape(3, 3, cin, a * (num_cls + 2)))
        sd[f"_detectors.conf.{i}.bias"] = b.reshape(a * (num_cls + 2))
    return sd
