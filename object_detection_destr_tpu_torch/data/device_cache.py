"""Device-resident dataset: decode once, gather batches on the device (port of
``object_detection_destr_tpu/data/device_cache.py``, l.37-159).

Every canvas the base loader would make is made once, through its own
``_make_batch`` (canvas resize or letterbox), and uploaded as uint8 with its
boxes, labels, valid flags and, where the loader letterboxes, ``content_hw``.
A batch is then ``index_select`` over the epoch's order on the device: the
only host-to-device traffic a step is its index row. The train transform
already runs on the device (``data/transforms.py``), so gather, augment and
step never leave it, and :class:`~..train.epoch_scan.EpochRunner` can
capture them in one CUDA graph. The set is decoded and uploaded
``_BUILD_CHUNK`` items at a time into tensors allocated on the device up
front, so the host holds one chunk, not the set.

The epoch order is the base loader's: the same ``np.random.default_rng((seed,
epoch))`` shuffle of the virtual indices (``augment_factor`` passes over the
set), so cached and uncached runs see the same batches, and ``state_dict`` /
``load_state_dict`` round-trip with :class:`~.loader.DetectionLoader`'s.
Its size: B canvases of C x C x 3 bytes (C = 672 at 640 px: 1,354,752 bytes
each) plus 17 bytes a target slot.

Under the base loader's data-parallel mesh every rank holds the whole set
(replicated, device_cache.py:71-74) and iteration yields the rank's rows of
each global batch; :meth:`DeviceCachedLoader.epoch_index_matrix` gives the
global batches, whose columns the epoch runner splits.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

__all__ = ["DeviceCachedLoader"]

_BUILD_CHUNK = 64  # items decoded and uploaded at a time


class DeviceCachedLoader:
    """Wrap a :class:`~.loader.DetectionLoader`; serve its batches from
    device memory. The base loader gives its decode and canvas logic during
    the one-time build and its configuration (batch size, shuffle seed,
    augment factor, drop_last); it is not touched afterwards. Iteration
    yields dicts of device tensors with the keys the base loader yields.
    ``nbytes`` and ``build_seconds`` record the cache's size and the time
    its build took (host decode and upload, waited for)."""

    def __init__(self, base, device: str | torch.device):
        self.base = base
        self.device = torch.device(device)
        self.mesh = base.mesh
        self.batch_size = base.batch_size
        self.letterbox = base.letterbox
        self.max_targets = base.max_targets
        self.augment_factor = base.augment_factor
        self.shuffle = base.shuffle
        self.seed = base.seed
        self.drop_last = base.drop_last
        self.epoch = base.epoch
        self._start_step = base._start_step
        self._step = self._start_step

        t0 = time.perf_counter()
        n = len(base.dataset)
        self._data: dict[str, torch.Tensor] = {}
        for lo in range(0, n, _BUILD_CHUNK):
            items = np.arange(lo, min(lo + _BUILD_CHUNK, n))
            chunk = {k: torch.from_numpy(v) for k, v in base._make_batch(items).items()}
            if not self._data:
                self._data = {k: torch.empty((n, *v.shape[1:]), dtype=v.dtype, device=self.device)
                              for k, v in chunk.items()}
            for k, v in chunk.items():
                self._data[k][lo: lo + len(v)].copy_(v)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.build_seconds = time.perf_counter() - t0
        self.nbytes = sum(t.numel() * t.element_size() for t in self._data.values())

    # ---- DetectionLoader's surface
    @property
    def num_samples(self) -> int:
        return len(self.base.dataset) * self.augment_factor

    def __len__(self) -> int:
        n = self.num_samples
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "step": self._step}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self._start_step = int(state["step"])
        self._step = self._start_step

    def _epoch_order(self) -> np.ndarray:
        """The base loader's order of this epoch (DetectionLoader._epoch_order)."""
        order = np.arange(self.num_samples)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        return order

    # ---- the scanned epoch's surface (train/epoch_scan.py)
    @property
    def data(self) -> dict[str, torch.Tensor]:
        """The device-resident set (read it, do not write it)."""
        return self._data

    def epoch_index_matrix(self) -> tuple[int, np.ndarray]:
        """This epoch's batches as one index matrix, without advancing:
        ``(start_step, idx)``, idx (n_batches - start_step, batch_size) int64
        indices into :attr:`data`, the batches ``__iter__`` would yield. Call
        :meth:`advance_epoch` when the epoch has run, so an interrupt inside
        it leaves the loader at the epoch's start with the state."""
        if not self.drop_last and self.num_samples % self.batch_size:
            raise ValueError("epoch_scan needs whole batches: enable drop_last or size the set by batch_size")
        order = self._epoch_order() % len(self.base.dataset)
        n_batches, start = len(self), self._start_step
        idx = order[start * self.batch_size: n_batches * self.batch_size]
        return start, idx.reshape(n_batches - start, self.batch_size).astype(np.int64)

    def advance_epoch(self) -> None:
        """Book one completed scanned epoch."""
        self._start_step = 0
        self._step = 0
        self.epoch += 1

    def gather(self, idx: torch.Tensor) -> dict[str, torch.Tensor]:
        """The batch of set indices ``idx`` (an int64 tensor on the device)."""
        return {k: v.index_select(0, idx) for k, v in self._data.items()}

    def __iter__(self) -> Iterator[dict]:
        order = self._epoch_order() % len(self.base.dataset)  # virtual -> set index
        n_batches, start = len(self), self._start_step
        self._start_step = 0
        self._step = start
        for step in range(start, n_batches):
            self._step = step + 1
            lo = step * self.batch_size
            idxs = order[lo: lo + self.batch_size]
            if self.mesh is not None:
                idxs = idxs[self.mesh.rows(len(idxs))]
            yield self.gather(torch.from_numpy(idxs).to(self.device))
        self.epoch += 1
        self._step = 0
