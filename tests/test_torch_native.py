"""The port's native decode / resize pool (``runtime/native.py``, its own
copies of ``batch_resize.cc`` and ``jpeg_decode.cc``) and the loader's three
batch paths, against the JAX package's library and loader.

* The same sources: the port's library and the JAX package's (loaded as two
  ctypes libraries from two paths; both export ``odtr_*``) give bit-equal
  batches, resized and decoded.
* Against PIL's decode and cv2's INTER_LINEAR resize: the 99th percentile of
  the difference at most 2 grey levels (``tests/test_runtime.py``).
* The loader on each path against JAX ``DetectionLoader`` on the same
  dataset: the native JPEG path (WIDER FACE, ``raw_item``) and the
  decoded-array path (synthetic scenes; PNG files send a COCO batch there
  too) bit-equal; the letterbox path (PyTorch's resize against cv2's) within
  one grey level. Without the native library the loader says so and resizes
  with PyTorch, within one grey level of the pool.
"""

import io

import numpy as np
import pytest
from PIL import Image

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from object_detection_destr_tpu.data.datasets import build_dataset as jax_build_dataset  # noqa: E402
from object_detection_destr_tpu.data.loader import DetectionLoader as JaxLoader  # noqa: E402
from object_detection_destr_tpu.runtime import native as jax_native  # noqa: E402
from object_detection_destr_tpu_torch.data import DetectionLoader, build_dataset  # noqa: E402
from object_detection_destr_tpu_torch.runtime import native  # noqa: E402

from test_torch_datasets import _write_coco, write_widerface  # noqa: E402

pytestmark = pytest.mark.skipif(not (native.is_available() and native.jpeg_available()),
                                reason="g++ or libjpeg's headers missing: the native pool cannot be built")


def _jpegs(sizes, seed=0):
    rng = np.random.default_rng(seed)
    blobs = []
    for h, w in sizes:
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(buf, format="JPEG", quality=92)
        blobs.append(buf.getvalue())
    return blobs


def test_library_builds_from_the_port_sources():
    assert jax_native.is_available()
    for name in ("resize", "jpeg"):
        path = native.library_path(name)
        assert path.startswith(native._BUILD_DIR) and path != jax_native._LIB_PATH
    assert native._libs["resize"]._name != jax_native.load_library()._name


def test_pool_bit_equal_to_jax_library():
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, size=s, dtype=np.uint8) for s in [(48, 64, 3), (100, 30, 3), (56, 56, 3)]]
    np.testing.assert_array_equal(native.batch_resize(images, 56), jax_native.batch_resize(images, 56))
    blobs = _jpegs([(60, 80), (100, 64), (300, 260)])  # the last one decodes at 1/2 scale (DCT domain)
    np.testing.assert_array_equal(native.batch_decode_resize(blobs, 48), jax_native.batch_decode_resize(blobs, 48))
    with pytest.raises(ValueError, match="index 1"):
        native.batch_decode_resize([blobs[0], b"not a jpeg"], 32)


def test_pool_against_pil_and_cv2():
    blobs = _jpegs([(60, 80), (100, 64)], seed=2)
    out = native.batch_decode_resize(blobs, 48)
    for i, b in enumerate(blobs):
        decoded = np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
        ref = cv2.resize(decoded, (48, 48), interpolation=cv2.INTER_LINEAR)
        assert np.percentile(np.abs(out[i].astype(int) - ref.astype(int)), 99) <= 2
        resized = native.batch_resize([decoded], 48)[0]
        assert np.percentile(np.abs(resized.astype(int) - ref.astype(int)), 99) <= 2


def _batches(ours, ref, n=2):
    got = []
    for a, b in zip(ours, ref):
        got.append((a, b))
        if len(got) == n:
            break
    return got


LK = dict(batch_size=2, canvas_size=40, max_targets=8, shuffle=True, seed=3, prefetch=0)


@pytest.mark.parametrize("path", ["jpeg", "decoded", "letterbox"])
def test_loader_paths_match_jax(tmp_path, path):
    if path == "decoded":
        kw = dict(image_size=32, num_samples=4, seed=1)
        ours_ds, ref_ds = build_dataset("synthetic", **kw), jax_build_dataset("synthetic", **kw)
    else:
        write_widerface(tmp_path, sizes=((40, 60), (50, 30), (36, 36), (44, 52)))
        ours_ds = build_dataset("widerface", str(tmp_path), "train")
        ref_ds = jax_build_dataset("widerface", str(tmp_path), "train")
    lk = dict(LK, letterbox=path == "letterbox")
    pairs = _batches(DetectionLoader(ours_ds, **lk), JaxLoader(ref_ds, **lk))
    assert pairs
    for a, b in pairs:
        assert set(a) == set(b)
        for k in a:
            if k == "images" and path == "letterbox":
                assert np.abs(a[k].astype(int) - b[k].astype(int)).max() <= 1
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_non_jpeg_and_missing_library(tmp_path, monkeypatch, capsys):
    _write_coco(tmp_path)  # three images, one a PNG: its batch takes the decoded-array path
    ours_ds = build_dataset("coco", str(tmp_path), "train")
    ref_ds = jax_build_dataset("coco", str(tmp_path), "train")
    lk = dict(LK, batch_size=3, shuffle=False)
    (a, b), = _batches(DetectionLoader(ours_ds, **lk), JaxLoader(ref_ds, **lk), n=1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # no native library at all: a notice, then PyTorch's resize
    monkeypatch.setattr(native, "is_available", lambda: False)
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    (c, _), = _batches(DetectionLoader(ours_ds, **lk), JaxLoader(ref_ds, **lk), n=1)
    assert "native jpeg library unavailable" in capsys.readouterr().out
    assert np.abs(c["images"].astype(int) - a["images"].astype(int)).max() <= 1
    np.testing.assert_array_equal(c["boxes"], a["boxes"])
