"""Native (C++) host code of the port (port of
``object_detection_destr_tpu/runtime/``): the threaded JPEG decode and
canvas resize pool the data loader uses (``native.py``, sources in ``cc/``)."""

from .native import batch_decode_resize, batch_resize, is_available, jpeg_available

__all__ = ["batch_decode_resize", "batch_resize", "is_available", "jpeg_available"]
