"""Metric logging without a host wait every step (port of
``object_detection_destr_tpu/train/logging_utils.py``, l.22-84).

Step metrics stay on the device until a flush, which reads them once, prints
their running means, appends them to ``log_dir/metrics.jsonl`` and, where
``torch.utils.tensorboard`` can be imported, writes them as TensorBoard
scalars with the JAX package's tags and steps: ``Loss/{prefix}/{key}`` at the
last pending step for a flush, the given tag and step for :meth:`scalar`.
TensorBoard is optional there and here: without the ``tensorboard`` package
the writer is skipped and ``tensorboard`` says so (host-side logging only;
nothing on the device depends on it).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["MetricLogger"]


class MetricLogger:
    """Running means of step metrics, printed and appended to
    ``log_dir/metrics.jsonl`` at each flush, and TensorBoard scalars beside
    them. On a data-parallel rank other than 0 the trainer gives no
    ``log_dir`` and ``echo=False``: that rank writes and prints nothing."""

    def __init__(self, log_dir: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # the tensorboard package is not installed: no event file
                pass
            else:
                self._tb = SummaryWriter(log_dir)
        self._pending: list[tuple[int, dict]] = []
        self._t0 = time.time()

    def accumulate(self, step: int, metrics: dict) -> None:
        """Keep the step's device metrics; nothing is read here."""
        self._pending.append((step, metrics))

    def flush(self, prefix: str = "train", echo: bool = True) -> dict:
        """Read every pending metric in one transfer; log the running means."""
        if not self._pending:
            return {}
        keys = self._pending[0][1].keys()
        stacked = {k: torch.stack([m[k].float() for _, m in self._pending]).cpu().numpy() for k in keys}
        means = {k: float(np.mean(v)) for k, v in stacked.items()}
        last_step = self._pending[-1][0]
        self._pending.clear()
        if self._jsonl:
            record = {"step": int(last_step), "prefix": prefix,
                      "time": round(time.time() - self._t0, 3), **{k: round(v, 6) for k, v in means.items()}}
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in means.items():
                self._tb.add_scalar(f"Loss/{prefix}/{k}", v, int(last_step))
        if echo and self.echo:
            body = " ".join(f"{k}={v:.4f}" for k, v in means.items())
            print(f"[{prefix} step {last_step}] {body}", flush=True)
        return means

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self.echo:
            print(f"{tag}={value:.4f} (step {step})", flush=True)
        if self._tb:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": int(step), "tag": tag, "value": float(value)}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
