from .convert import load_flax_variables, load_variables_npz, save_variables_npz, state_dict_from_flax
from .resnet import FrozenBatchNorm, ResNet, downsample_mask, resnet50, resnet101

__all__ = [
    "FrozenBatchNorm",
    "ResNet",
    "downsample_mask",
    "load_flax_variables",
    "load_variables_npz",
    "resnet50",
    "resnet101",
    "save_variables_npz",
    "state_dict_from_flax",
]
