"""Carry flax variables into the port's modules, and the port's weights file.

``variables`` is the flax ``{"params", "batch_stats"}`` tree with numpy
leaves. Module names follow the flax ones, so a flax path maps to a torch
state-dict key by joining with ``.`` and renaming the leaf:

    Dense kernel (in, out)           -> weight, transposed
    Conv kernel HWIO                 -> weight, OIHW (the stem's (7,7,3,64) too)
    LayerNorm / BatchNorm scale      -> weight
    BatchNorm batch_stats mean / var -> running_mean / running_var
    FrozenBatchNorm's four params    -> parameters of the same names
    nn.Embed embedding               -> weight

The weights file is that tree flattened with ``/`` keys into an ``.npz``
(``params/backbone/conv1/kernel`` ...). A checkpoint of the JAX package's
trainer (Orbax) becomes one with ``tools/orbax_to_npz.py``, which needs JAX
and lives outside both packages.

Torch checkpoints come in through the importers (port of
``object_detection_destr_tpu/models/convert.py``, l.23-347): a torchvision
ResNet or VGG-16 ``state_dict`` (the backbones the reference loads,
backbone.py:124-145, model_ssd.py:137-149), or a whole reference DESTR or
SSD ``state_dict``. Each returns the numpy flax tree that the JAX importer
of the same name returns (HWIO conv kernels, ``(in, out)`` Dense kernels),
so a torch checkpoint reaches a port module through the one transposition
above (:func:`load_flax_variables`). The values are carried bit for bit.
No torchvision is needed: the importers read the plain key layout of
``torchvision.models.resnet50().state_dict()`` / ``vgg16().state_dict()``,
as tensors or numpy arrays.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn

__all__ = [
    "state_dict_from_flax",
    "flax_variables_from_state_dict",
    "load_flax_variables",
    "load_variables_npz",
    "save_variables_npz",
    "resnet_params_from_torch",
    "vgg16_params_from_torch",
    "destr_encoder_params_from_torch",
    "destr_decoder_params_from_torch",
    "destr_variables_from_torch",
    "ssd_variables_from_torch",
]

_COLLECTIONS = ("params", "batch_stats")
# torch buffers that have no flax counterpart
_TORCH_ONLY = ("num_batches_tracked",)


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _torch_leaf(collection: str, leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if collection == "batch_stats":
        return {"mean": "running_mean", "var": "running_var"}[leaf], value
    if leaf == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    if leaf in ("scale", "embedding"):
        return "weight", value
    return leaf, value  # bias, and FrozenBatchNorm's weight/bias/running_*


def state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Torch state-dict entries for every leaf of a flax variables tree."""
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    state = {}
    for collection in _COLLECTIONS:
        for path, value in _flatten(variables.get(collection, {})).items():
            leaf, value = _torch_leaf(collection, path[-1], value)
            key = ".".join(path[:-1] + (leaf,))
            if key in state:
                raise ValueError(f"two flax leaves map to {key}")
            state[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def flax_variables_from_state_dict(model: nn.Module) -> dict:
    """The inverse: the flax-layout numpy tree of a port model's weights."""
    bn_stats = {
        f"{name}.{buf}": stat
        for name, module in model.named_modules()
        if isinstance(module, nn.BatchNorm2d)
        for buf, stat in (("running_mean", "mean"), ("running_var", "var"))
    }
    kinds = {name: type(module) for name, module in model.named_modules()}
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, tensor in model.state_dict().items():
        module, leaf = key.rsplit(".", 1)
        if leaf in _TORCH_ONLY:
            continue
        value = tensor.detach().cpu().numpy()
        collection = "params"
        if key in bn_stats:
            collection, leaf = "batch_stats", bn_stats[key]
        elif leaf == "weight" and kinds[module] is nn.Linear:
            leaf, value = "kernel", value.T
        elif leaf == "weight" and kinds[module] is nn.Conv2d:
            leaf, value = "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "weight" and kinds[module] in (nn.LayerNorm, nn.BatchNorm2d):
            leaf = "scale"
        elif leaf == "weight" and kinds[module] is nn.Embedding:
            leaf = "embedding"
        node = tree[collection]
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.array(value)  # a copy: later steps must not change it
    return tree


def load_flax_variables(model: nn.Module, variables: Mapping, strict: bool = True) -> nn.Module:
    """Copy a flax variables tree into ``model`` in place.

    ``strict`` requires every flax leaf to be consumed and every parameter
    and buffer of the model to be set (``num_batches_tracked`` has no flax
    counterpart and is left as it is)."""
    incoming = state_dict_from_flax(variables)
    own = {k: v for k, v in model.state_dict().items() if k.rsplit(".", 1)[-1] not in _TORCH_ONLY}
    if strict:
        unused = sorted(set(incoming) - set(own))
        missing = sorted(set(own) - set(incoming))
        if unused or missing:
            raise KeyError(f"flax leaves with no port tensor: {unused[:8]}; "
                           f"port tensors with no flax leaf: {missing[:8]}")
    with torch.no_grad():
        for key, value in incoming.items():
            if key not in own:
                continue
            if tuple(own[key].shape) != tuple(value.shape):
                raise ValueError(f"{key}: flax {tuple(value.shape)} vs port {tuple(own[key].shape)}")
            own[key].copy_(value)
    return model


def save_variables_npz(variables: Mapping, path: str) -> None:
    """Write a flax variables tree (numpy leaves) as an ``.npz`` with ``/`` keys."""
    np.savez(path, **{"/".join(p): v for p, v in _flatten(variables).items()})


def load_variables_npz(path: str) -> dict:
    """Read an ``.npz`` written by :func:`save_variables_npz` back into a tree."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


# ---- torch checkpoints -> flax trees (convert.py:33-347 of the JAX package)

def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv_kernel(t) -> np.ndarray:
    """torch OIHW -> flax HWIO."""
    return _np(t).transpose(2, 3, 1, 0)


def _bn(sd: Mapping[str, Any], prefix: str) -> dict:
    return {
        "weight": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
        "running_mean": _np(sd[f"{prefix}.running_mean"]),
        "running_var": _np(sd[f"{prefix}.running_var"]),
    }


def resnet_params_from_torch(
    sd: Mapping[str, Any], stage_sizes: Sequence[int] = (3, 4, 6, 3)
) -> dict:
    """Map a torchvision ResNet state_dict to the ``models/resnet.ResNet``
    param tree (use as ``params["backbone"]`` in the DESTR model).

    Key mapping:
        conv1.weight                  -> conv1/kernel (HWIO)
        bn1.*                         -> bn1/*
        layerS.I.convJ.weight         -> layer{S}_{I}/convJ/kernel
        layerS.I.bnJ.*                -> layer{S}_{I}/bnJ/*
        layerS.I.downsample.0.weight  -> layer{S}_{I}/downsample_conv/kernel
        layerS.I.downsample.1.*       -> layer{S}_{I}/downsample_bn/*
    (fc.* is dropped — the backbone is headless, backbone.py:101.)
    """
    params: dict = {
        "conv1": {"kernel": _conv_kernel(sd["conv1.weight"])},
        "bn1": _bn(sd, "bn1"),
    }
    for stage, blocks in enumerate(stage_sizes, start=1):
        for i in range(blocks):
            scope = f"layer{stage}_{i}"
            tp = f"layer{stage}.{i}"
            block = {}
            for j in (1, 2, 3):
                block[f"conv{j}"] = {"kernel": _conv_kernel(sd[f"{tp}.conv{j}.weight"])}
                block[f"bn{j}"] = _bn(sd, f"{tp}.bn{j}")
            if f"{tp}.downsample.0.weight" in sd:
                block["downsample_conv"] = {
                    "kernel": _conv_kernel(sd[f"{tp}.downsample.0.weight"])
                }
                block["downsample_bn"] = _bn(sd, f"{tp}.downsample.1")
            params[scope] = block
    return params


def _linear(sd: Mapping[str, Any], prefix: str, bias: bool = True) -> dict:
    """torch Linear (out, in) -> flax Dense kernel (in, out) [+ bias]."""
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if bias:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd: Mapping[str, Any], prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def destr_encoder_params_from_torch(sd: Mapping[str, Any], num_blocks: int = 6) -> dict:
    """Map the reference DESTR ``Encoder`` state_dict (encoder_block.py:8-112)
    onto ``models/destr/encoder.Encoder``'s param tree.

    torch ``nn.MultiheadAttention`` packs q/k/v into ``in_proj_weight``
    (3C, C) — split row-wise into our separate q/k/v Dense kernels. The
    reference's dead ``_proj_to_{q,k,v}`` Linears (never called,
    encoder_block.py:76-82) are dropped.
    """
    params: dict = {
        "pos_scale": {
            "fc0": _linear(sd, "_pos_scale.0"),
            "fc1": _linear(sd, "_pos_scale.2"),
        },
        "outer_norm": _layernorm(sd, "norm"),
    }
    for i in range(num_blocks):
        tp = f"_encoder.{i}"
        w = _np(sd[f"{tp}.self_attn.in_proj_weight"])  # (3C, C)
        b = _np(sd[f"{tp}.self_attn.in_proj_bias"])  # (3C,)
        c = w.shape[1]
        attn = {
            "q_proj": {"kernel": w[:c].T, "bias": b[:c]},
            "k_proj": {"kernel": w[c : 2 * c].T, "bias": b[c : 2 * c]},
            "v_proj": {"kernel": w[2 * c :].T, "bias": b[2 * c :]},
            "out_proj": _linear(sd, f"{tp}.self_attn.out_proj"),
        }
        params[f"block{i}"] = {
            "self_attn": attn,
            "fc1": _linear(sd, f"{tp}.fc1"),
            "fc2": _linear(sd, f"{tp}.fc2"),
            "norm1": _layernorm(sd, f"{tp}.norm1"),
            "norm2": _layernorm(sd, f"{tp}.norm2"),
        }
    return params


def destr_decoder_params_from_torch(sd: Mapping[str, Any], num_blocks: int = 6) -> dict:
    """Map the reference DESTR ``Decoder`` state_dict (decoder_block.py:12-274)
    onto ``models/destr/decoder.Decoder``'s param tree (all self/cross
    projection Linears are bias-free in both)."""
    params: dict = {
        "pos_scale": {
            "fc0": _linear(sd, "_pos_scale.0"),
            "fc1": _linear(sd, "_pos_scale.2"),
        },
        "outer_norm": _layernorm(sd, "norm"),
    }
    proj_map = {
        "sa_q_obj": "_sa_proj_to_q_obj",
        "sa_q_pos": "_sa_proj_to_q_pos",
        "sa_k_obj": "_sa_proj_to_k_obj",
        "sa_k_pos": "_sa_proj_to_k_pos",
        "sa_v_obj": "_sa_proj_to_v_obj",
        "ca_q_obj": "_ca_proj_to_q_obj",
        "ca_q_pos": "_ca_proj_to_q_pos",
        "ca_k_enc": "_ca_proj_to_k_enc",
        "ca_k_pos": "_ca_proj_to_k_pos",
        "ca_v_enc": "_ca_proj_to_v_enc",
    }
    for i in range(num_blocks):
        tp = f"_decoder.{i}"
        block: dict = {
            ours: _linear(sd, f"{tp}.{theirs}", bias=False)
            for ours, theirs in proj_map.items()
        }
        block["norm1"] = _layernorm(sd, f"{tp}.norm1")
        block["norm2"] = _layernorm(sd, f"{tp}.norm2")
        for branch, theirs in (("cls_branch", "_cls_branch"), ("reg_branch", "_reg_branch")):
            block[branch] = {
                "fc1": _linear(sd, f"{tp}.{theirs}.fc1"),
                "fc2": _linear(sd, f"{tp}.{theirs}.fc2"),
                "norm1": _layernorm(sd, f"{tp}.{theirs}.norm1"),
                "norm2": _layernorm(sd, f"{tp}.{theirs}.norm2"),
            }
        params[f"block{i}"] = block
    return params


# conv layer indices of vgg16().features[:23] (conv1_1 .. conv4_3)
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)


def vgg16_params_from_torch(sd: Mapping[str, Any]) -> dict:
    """Map ``vgg16().features`` (or full-model ``features.``-prefixed) keys to
    the ``models/ssd.VGG16Features`` param tree (use as ``params["backbone"]``).
    """
    prefix = "features." if any(k.startswith("features.") for k in sd) else ""
    params = {}
    for our_i, torch_i in enumerate(_VGG16_CONV_IDX):
        params[f"conv{our_i}"] = {
            "kernel": _conv_kernel(sd[f"{prefix}{torch_i}.weight"]),
            "bias": _np(sd[f"{prefix}{torch_i}.bias"]),
        }
    return params


def _conv2d(sd: Mapping[str, Any], prefix: str) -> dict:
    return {
        "kernel": _conv_kernel(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
    }


def _strip(sd: Mapping[str, Any], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def destr_variables_from_torch(
    sd: Mapping[str, Any],
    num_encoder_blocks: int = 6,
    num_decoder_blocks: int = 6,
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
) -> dict:
    """Map a FULL reference ``ObjDetSplitTransformer`` state_dict
    (model.py:14-71) onto this model's flax variables
    ``{"params": ..., "batch_stats": ...}`` — i.e. load a reference DESTR
    checkpoint wholesale.

    Component prefixes in the reference state dict:
      ``_backbone.0.body.*``  ResNet-50 (Joiner[0] -> BackboneBase.body)
      ``_encoder.*`` / ``_decoder.*``  transformer stacks
      ``_cls_embed / _bbox_embed / _reg_ffn``  shared heads (our ``pos_head``
      is the reference's ``_reg_ffn``, model.py:40-50)
      ``_reduce_dim``  1x1 conv 2048 -> C (model.py:60-65)
      ``_mini_detector.*``  conv stacks (see below)
      ``_pos_scale``  DEAD code (declared model.py:51-57, never called —
      forward uses ``_encoder._pos_scale``, model.py:90) — dropped.

    Mini-detector BN un-scrambling: the reference appends the BN layers of
    the reg/pos stacks into ``_cls_conv`` (mini_detector.py:45,58 — SURVEY
    §2.1 #6 defect), so ``_cls_conv`` holds 4x(conv,BN) at indices 0..7 plus
    the reg-stack BNs at 8..11 and pos-stack BNs at 12..15, while
    ``_reg_conv``/``_pos_conv`` hold bare convs. This converter routes those
    misplaced BNs back to the stacks they were constructed for (our fixed
    wiring, REFCOMPAT #1). At a fresh init every BN is identity in eval mode,
    so converted-init eval forward matches the reference exactly. For a
    *trained* reference checkpoint the mapping stays well-defined but is only
    approximate around the mini-detector: the reference executed the
    misplaced BNs inside its cls path (iterating ``_cls_conv`` runs all 16
    modules), so their trained statistics reflect cls activations, not the
    reg/pos stacks they now normalize.
    """
    params: dict = {
        "backbone": resnet_params_from_torch(
            _strip(sd, "_backbone.0.body."), stage_sizes
        ),
        "encoder": destr_encoder_params_from_torch(
            _strip(sd, "_encoder."), num_encoder_blocks
        ),
        "decoder": destr_decoder_params_from_torch(
            _strip(sd, "_decoder."), num_decoder_blocks
        ),
        "cls_embed": _linear(sd, "_cls_embed"),
        "bbox_embed": {
            "fc0": _linear(sd, "_bbox_embed.0"),
            "fc1": _linear(sd, "_bbox_embed.2"),
        },
        "pos_head": {
            "fc0": _linear(sd, "_reg_ffn.0"),
            "fc1": _linear(sd, "_reg_ffn.2"),
            "fc2": _linear(sd, "_reg_ffn.4"),
        },
        "reduce_dim": _conv2d(sd, "_reduce_dim"),
    }

    md = "_mini_detector"
    # (our stack name, conv source prefix fn, BN index in _cls_conv)
    stacks = (
        ("cls_conv", lambda i: f"{md}._cls_conv.{2 * i}", lambda i: 2 * i + 1),
        ("reg_conv", lambda i: f"{md}._reg_conv.{i}", lambda i: 8 + i),
        ("pos_conv", lambda i: f"{md}._pos_conv.{i}", lambda i: 12 + i),
    )
    mini_params: dict = {}
    mini_stats: dict = {}
    for ours, conv_src, bn_idx in stacks:
        p: dict = {}
        s: dict = {}
        for i in range(4):
            p[f"conv{i}"] = _conv2d(sd, conv_src(i))
            bn = f"{md}._cls_conv.{bn_idx(i)}"
            p[f"bn{i}"] = {"scale": _np(sd[f"{bn}.weight"]),
                           "bias": _np(sd[f"{bn}.bias"])}
            s[f"bn{i}"] = {"mean": _np(sd[f"{bn}.running_mean"]),
                           "var": _np(sd[f"{bn}.running_var"])}
        mini_params[ours] = p
        mini_stats[ours] = s
    params["mini_detector"] = mini_params

    return {"params": params, "batch_stats": {"mini_detector": mini_stats}}


def ssd_variables_from_torch(sd: Mapping[str, Any], num_cls: int = 20) -> dict:
    """Map a FULL reference ``SingleShotDetector`` state_dict
    (model_ssd.py:6-149) onto our SSD flax variables
    ``{"params": ..., "batch_stats": ...}``.

    Component prefixes:
      ``_backbone._layers.{j}``      VGG16 features[:23] convs
      ``_feature_maps.{i}.{0,1,3,4}`` extra blocks (conv1, bn1, conv2, bn2)
      ``_detectors.boxes.{i}`` / ``_detectors.conf.{i}``  3x3 heads

    Confidence-head channel surgery (REFCOMPAT #4): the reference allocates
    ``A * (num_cls + 2)`` channels per scale — background double-counted;
    its softmax uses labels 0..num_cls-1 for classes and channel ``-1``
    (num_cls + 1) for background (criterion.py:324-328), leaving channel
    ``num_cls`` dead. Ours has ``A * (num_cls + 1)`` with background last,
    so per anchor the kept reference channels are [0..num_cls-1, num_cls+1].
    """
    params: dict = {
        "backbone": vgg16_params_from_torch(
            {k[len("_backbone._layers."):]: v for k, v in sd.items()
             if k.startswith("_backbone._layers.")}
        )
    }
    stats: dict = {}
    for i in range(5):
        tp = f"_feature_maps.{i}"
        params[f"extra{i}"] = {
            "conv1": {"kernel": _conv_kernel(sd[f"{tp}.0.weight"])},
            "conv2": {"kernel": _conv_kernel(sd[f"{tp}.3.weight"])},
            "bn1": {"scale": _np(sd[f"{tp}.1.weight"]),
                    "bias": _np(sd[f"{tp}.1.bias"])},
            "bn2": {"scale": _np(sd[f"{tp}.4.weight"]),
                    "bias": _np(sd[f"{tp}.4.bias"])},
        }
        stats[f"extra{i}"] = {
            "bn1": {"mean": _np(sd[f"{tp}.1.running_mean"]),
                    "var": _np(sd[f"{tp}.1.running_var"])},
            "bn2": {"mean": _np(sd[f"{tp}.4.running_mean"]),
                    "var": _np(sd[f"{tp}.4.running_var"])},
        }

    anchors = (4, 6, 6, 6, 4, 4)  # model_ssd.py:11
    keep = list(range(num_cls)) + [num_cls + 1]
    for i, a in enumerate(anchors):
        params[f"box_head{i}"] = _conv2d(sd, f"_detectors.boxes.{i}")
        w = _conv_kernel(sd[f"_detectors.conf.{i}.weight"])  # (3,3,in, A*(C+2))
        b = _np(sd[f"_detectors.conf.{i}.bias"])
        cin = w.shape[2]
        w = w.reshape(3, 3, cin, a, num_cls + 2)[..., keep]
        b = b.reshape(a, num_cls + 2)[:, keep]
        params[f"conf_head{i}"] = {
            "kernel": w.reshape(3, 3, cin, a * (num_cls + 1)),
            "bias": b.reshape(a * (num_cls + 1)),
        }
    return {"params": params, "batch_stats": stats}
