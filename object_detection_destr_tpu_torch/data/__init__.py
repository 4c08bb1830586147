from .loader import _letterbox_canvas, _resize_canvas
from .transforms import letterbox_infer_transform, normalize_imagenet

__all__ = ["_letterbox_canvas", "_resize_canvas", "letterbox_infer_transform", "normalize_imagenet"]
