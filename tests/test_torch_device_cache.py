"""The port's device-resident dataset (data/device_cache.py) against the JAX
package's (``DeviceCachedLoader``) and against the port's host loader.

At a canvas equal to the items' size nothing is resized, so every batch is
compared exactly: the epoch index matrix and the gathered batches of the two
packages' caches, the cache's batches against the host loader it wraps
(letterboxed, two epochs), and a ``state_dict`` that either loader wrote
resuming the other mid-epoch.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_destr_tpu.data import DetectionLoader as JaxLoader  # noqa: E402
from object_detection_destr_tpu.data import build_dataset as jax_build_dataset  # noqa: E402
from object_detection_destr_tpu.data.device_cache import DeviceCachedLoader as JaxCache  # noqa: E402
from object_detection_destr_tpu_torch.data import DetectionLoader, build_dataset  # noqa: E402
from object_detection_destr_tpu_torch.data import device_cache  # noqa: E402
from object_detection_destr_tpu_torch.data.device_cache import DeviceCachedLoader  # noqa: E402

SET = dict(split="train", image_size=32, num_samples=9, max_items_per_img=4, seed=2)
LOADER = dict(batch_size=3, canvas_size=32, max_targets=4, shuffle=True, seed=5, prefetch=0, num_workers=0)


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    """Build the caches 4 items at a time, so the sets of 9 and 10 items
    upload in several chunks, the last one short."""
    monkeypatch.setattr(device_cache, "_BUILD_CHUNK", 4)


def _pair(augment_factor):
    ours = DeviceCachedLoader(DetectionLoader(build_dataset("synthetic", **SET), augment_factor=augment_factor,
                                              **LOADER), "cpu")
    ref = JaxCache(JaxLoader(jax_build_dataset("synthetic", **SET), augment_factor=augment_factor, **LOADER))
    return ours, ref


@pytest.mark.parametrize("augment_factor", [1, 2])
def test_epoch_index_matrix_and_batches_match_jax(augment_factor):
    ours, ref = _pair(augment_factor)
    assert len(ours) == len(ref) == 3 * augment_factor
    for key in ref.data:
        np.testing.assert_array_equal(ours.data[key].numpy(), np.asarray(ref.data[key]), err_msg=key)
    for _ in range(2):  # the shuffle moves on with the epoch in both
        (start, idx), (ref_start, ref_idx) = ours.epoch_index_matrix(), ref.epoch_index_matrix()
        assert start == ref_start == 0 and idx.dtype == np.int64
        np.testing.assert_array_equal(idx, ref_idx)
        for row in idx:
            mine = ours.gather(torch.from_numpy(row))
            theirs = ref._gather(ref.data, jnp.asarray(row, jnp.int32))
            for key in theirs:
                np.testing.assert_array_equal(mine[key].numpy(), np.asarray(theirs[key]), err_msg=key)
        ours.advance_epoch()
        ref.advance_epoch()
        assert ours.state_dict() == ref.state_dict()


def test_cache_matches_the_host_loader_and_resumes():
    """Bit-identical batches in the host loader's order, letterboxed, over two
    epochs; a state_dict taken mid-epoch resumes a fresh cache and the host
    loader at the same batch."""
    from object_detection_destr_tpu_torch.data import SyntheticDetection

    make = lambda: DetectionLoader(SyntheticDetection(num_samples=10, image_size=48, max_boxes=3), batch_size=4,
                                   canvas_size=56, max_targets=5, augment_factor=2, shuffle=True, seed=3,
                                   prefetch=0, num_workers=0, letterbox=True)
    host, cached = make(), DeviceCachedLoader(make(), "cpu")
    assert len(host) == len(cached) == 5
    assert cached.nbytes == sum(t.numel() * t.element_size() for t in cached.data.values())
    for _ in range(2):
        host_batches, cached_batches = list(host), list(cached)
        assert len(host_batches) == len(cached_batches) == 5
        for hb, cb in zip(host_batches, cached_batches):
            assert sorted(hb) == sorted(cb) == ["boxes", "content_hw", "images", "labels", "valid"]
            for key in hb:
                np.testing.assert_array_equal(hb[key], cb[key].numpy(), err_msg=key)
    assert cached.state_dict() == host.state_dict() == {"epoch": 2, "step": 0}

    it = iter(cached)
    next(it), next(it)
    state = cached.state_dict()
    assert state == {"epoch": 2, "step": 2}
    rest_cached = list(it)
    resumed_host, resumed_cache = make(), DeviceCachedLoader(make(), "cpu")
    resumed_host.load_state_dict(state)
    resumed_cache.load_state_dict(state)
    assert resumed_cache.epoch_index_matrix()[0] == 2
    rest_host, rest_resumed = list(resumed_host), list(resumed_cache)
    assert len(rest_host) == len(rest_resumed) == len(rest_cached) == 3
    for a, b, c in zip(rest_host, rest_resumed, rest_cached):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key].numpy(), err_msg=key)
            np.testing.assert_array_equal(a[key], c[key].numpy(), err_msg=key)


def test_index_matrix_needs_whole_batches():
    loader = DetectionLoader(build_dataset("synthetic", **SET), augment_factor=1, drop_last=False,
                             **{**LOADER, "batch_size": 4})
    cache = DeviceCachedLoader(loader, "cpu")
    with pytest.raises(ValueError, match="whole batches"):
        cache.epoch_index_matrix()
