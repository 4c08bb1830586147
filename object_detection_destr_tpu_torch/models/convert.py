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
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = [
    "state_dict_from_flax",
    "flax_variables_from_state_dict",
    "load_flax_variables",
    "load_variables_npz",
    "save_variables_npz",
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
