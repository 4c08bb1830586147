"""ctypes bindings and the build at first use of the native decode / resize
pool (port of ``object_detection_destr_tpu/runtime/native.py``).

The port keeps its own copies of the sources, ``cc/batch_resize.cc`` (a
bilinear canvas resize of decoded uint8 images over a ``std::thread`` pool,
half-pixel centres as cv2's INTER_LINEAR) and ``cc/jpeg_decode.cc`` (the
fused libjpeg decode + the same resize, with libjpeg's DCT-domain downscale
when the source is at least twice the canvas on both axes). Each is built
with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into the package's
``_build/`` at first use (rebuilt when its source is newer) and loaded with
ctypes: ``libodtt_resize.so``, and ``libodtt_jpeg.so`` linked with
``-ljpeg``. They are two libraries so that a host without libjpeg's headers
still has the resize: :func:`is_available` and :func:`jpeg_available` say
which built, and :func:`unavailable_reason` why one did not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "SOURCES",
    "batch_decode_resize",
    "batch_resize",
    "is_available",
    "jpeg_available",
    "library_path",
    "unavailable_reason",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# library -> (sources, extra link flags)
SOURCES = {
    "resize": ([os.path.join(_HERE, "cc", "batch_resize.cc")], []),
    "jpeg": ([os.path.join(_HERE, "cc", "jpeg_decode.cc")], ["-ljpeg"]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_failed: dict[str, str] = {}


def library_path(name: str) -> str:
    return os.path.join(_BUILD_DIR, f"libodtt_{name}.so")


def _build(name: str) -> None:
    sources, link = SOURCES[name]
    path = library_path(name)
    if os.path.exists(path) and os.path.getmtime(path) >= max(os.path.getmtime(s) for s in sources):
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", *sources, "-o", tmp, *link]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()[-400:]}")
    os.replace(tmp, path)


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "resize":
        lib.odtr_runtime_abi_version.restype = ctypes.c_int32
        if lib.odtr_runtime_abi_version() != 1:
            raise RuntimeError(f"{library_path(name)} has a stale ABI; delete it to rebuild")
        lib.odtr_batch_resize.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.odtr_batch_resize.restype = None
    else:
        lib.odtr_batch_decode_resize.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.odtr_batch_decode_resize.restype = None


def _load(name: str) -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None (with the reason kept) when
    it cannot be built or loaded."""
    if name in _libs or name in _failed:
        return _libs.get(name)
    with _lock:
        if name not in _libs and name not in _failed:
            try:
                _build(name)
                lib = ctypes.CDLL(library_path(name))
                _bind(name, lib)
                _libs[name] = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _failed[name] = f"{type(e).__name__}: {e}"
    return _libs.get(name)


def is_available() -> bool:
    """Whether the resize library built and loaded."""
    return _load("resize") is not None


def jpeg_available() -> bool:
    """Whether the JPEG decode library built and loaded (it needs libjpeg)."""
    return _load("jpeg") is not None


def unavailable_reason(name: str) -> Optional[str]:
    """Why library ``name`` ("resize" or "jpeg") did not build or load; None
    if it did or was not tried yet."""
    return _failed.get(name)


def _require(name: str) -> ctypes.CDLL:
    lib = _load(name)
    if lib is None:
        raise RuntimeError(f"native {name} library unavailable: {_failed[name]}")
    return lib


def batch_resize(images: Sequence[np.ndarray], canvas: int) -> np.ndarray:
    """Resize HWC uint8 images onto one (N, canvas, canvas, C) batch (bilinear,
    stretching) on every core."""
    lib = _require("resize")
    n = len(images)
    ch = images[0].shape[2] if images[0].ndim == 3 else 1
    if any(im.shape[2:] != images[0].shape[2:] or im.ndim not in (2, 3) for im in images):
        raise ValueError("batch_resize: every image must be (H, W) or (H, W, C) with one C")
    out = np.empty((n, canvas, canvas, ch), np.uint8)
    contiguous = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data_as(ctypes.c_void_p).value for im in contiguous])
    hs = (ctypes.c_int32 * n)(*[im.shape[0] for im in contiguous])
    ws = (ctypes.c_int32 * n)(*[im.shape[1] for im in contiguous])
    lib.odtr_batch_resize(ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), hs, ws, n,
                          out.ctypes.data_as(ctypes.c_void_p), canvas, ch, 0)
    return out


def batch_decode_resize(jpeg_blobs: Sequence[bytes], canvas: int) -> np.ndarray:
    """Decode JPEG byte blobs and resize them onto one (N, canvas, canvas, 3)
    uint8 batch on every core. Raises ValueError naming the first image whose
    decode failed."""
    lib = _require("jpeg")
    n = len(jpeg_blobs)
    out = np.empty((n, canvas, canvas, 3), np.uint8)
    bufs = [np.frombuffer(b, np.uint8) for b in jpeg_blobs]
    ptrs = (ctypes.c_void_p * n)(*[buf.ctypes.data_as(ctypes.c_void_p).value for buf in bufs])
    lens = (ctypes.c_int64 * n)(*[len(b) for b in jpeg_blobs])
    status = (ctypes.c_int32 * n)()
    lib.odtr_batch_decode_resize(ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), lens, n,
                                 out.ctypes.data_as(ctypes.c_void_p), canvas, 0, status)
    bad = [i for i in range(n) if status[i] != 0]
    if bad:
        raise ValueError(f"JPEG decode failed for image index {bad[0]} (of {len(bad)} failures)")
    return out
