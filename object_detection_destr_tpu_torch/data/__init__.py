from .datasets import SyntheticDetection, build_dataset
from .loader import DetectionLoader, _letterbox_canvas, _resize_canvas
from .transforms import (
    destr_train_transform,
    letterbox_infer_transform,
    normalize_imagenet,
    ssd_eval_transform,
    ssd_train_transform,
)

__all__ = [
    "DetectionLoader",
    "SyntheticDetection",
    "_letterbox_canvas",
    "_resize_canvas",
    "build_dataset",
    "destr_train_transform",
    "letterbox_infer_transform",
    "normalize_imagenet",
    "ssd_eval_transform",
    "ssd_train_transform",
]
