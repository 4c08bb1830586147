"""The DESTR training loop (port of the training half of
``object_detection_destr_tpu/train/driver.py::train_destr``, l.219-371).

Per epoch: batches from the loader, the train transform on the model's
device (its draws from a generator seeded ``seed + 7``), one train step each,
the running mean of the step metrics printed every ``log_interval`` steps as
``[train step N] loss=...`` (and appended to ``log_dir/metrics.jsonl``), then
``Perf/images_per_sec`` over the epoch. The loop halts as the JAX driver
does when the parameters stop being finite.

The validation sweep with its mAP, checkpoints and resume, parameter EMA,
the device-resident dataset, scanned epochs, COCO evaluation, gradient
accumulation, profiling, letterbox training, other optimizer layouts and
multi-device training come with later slices: their flags raise
``NotImplementedError`` here when set away from their defaults.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config, DataConfig, TrainConfig, resolve_device
from ..data import DetectionLoader, build_dataset
from ..data.transforms import destr_train_transform
from ..models.destr.model import build_destr
from .state import create_destr_state
from .steps import make_destr_train_step

__all__ = ["train_destr", "MetricLogger", "StepTimer"]

# (section, field) of each feature of a later slice, checked against the default
_LATER_SLICES = [
    ("train", "ema_decay"), ("train", "epoch_scan"), ("train", "coco_eval"),
    ("train", "grad_accum_steps"), ("train", "profile_dir"), ("train", "letterbox"),
    ("train", "resume"), ("train", "resume_from"), ("train", "save_as"),
    ("train", "checkpoint_dir"), ("train", "val_interval"), ("train", "save_interval"),
    ("train", "moment_dtype"), ("train", "rng_impl"), ("train", "num_data_shards"),
    ("train", "letterbox_eval"), ("data", "device_cache"), ("data", "num_valid_samples"),
]
_DEFAULTS = {"train": TrainConfig(), "data": DataConfig()}


def _refuse_later_slices(config: Config) -> None:
    for section, field in _LATER_SLICES:
        value = getattr(getattr(config, section), field)
        if value != getattr(_DEFAULTS[section], field):
            raise NotImplementedError(
                f"{section}.{field}={value!r}: this feature is not ported yet "
                "(the port trains; validation, checkpoints, EMA and the rest come later)"
            )
    if config.train.opt_layout not in ("auto", "per-leaf"):
        raise NotImplementedError(f"opt_layout={config.train.opt_layout!r}: only per-leaf is ported")


class MetricLogger:
    """Running means of step metrics, printed and appended to
    ``log_dir/metrics.jsonl`` at each flush (logging_utils.py:22-84); the
    device values are read once per flush."""

    def __init__(self, log_dir: Optional[str] = None):
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._pending: list[tuple[int, dict]] = []
        self._t0 = time.time()

    def accumulate(self, step: int, metrics: dict) -> None:
        self._pending.append((step, metrics))

    def flush(self, prefix: str = "train", echo: bool = True) -> dict:
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
        if echo:
            body = " ".join(f"{k}={v:.4f}" for k, v in means.items())
            print(f"[{prefix} step {last_step}] {body}", flush=True)
        return means

    def scalar(self, tag: str, value: float, step: int) -> None:
        print(f"{tag}={value:.4f} (step {step})", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": int(step), "tag": tag, "value": float(value)}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()


class StepTimer:
    """Epoch throughput from the host clock around work that ends in a
    synchronize, and on a GPU each step's time from CUDA events recorded
    between steps (``step_ms``)."""

    def __init__(self, batch_size: int, device: torch.device):
        self.batch_size = batch_size
        self.cuda = device.type == "cuda"
        self.step_ms: list[float] = []
        self._events: list = []
        self._t0 = 0.0
        self._steps = 0

    def _mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._events.append(event)

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._events = []
        self._mark()

    def step(self) -> None:
        self._steps += 1
        self._mark()

    def stop(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
            self.step_ms += [a.elapsed_time(b) for a, b in zip(self._events, self._events[1:])]
        dt = time.perf_counter() - self._t0
        steps = max(self._steps, 1)
        return {"seconds": dt, "steps_per_sec": steps / dt, "images_per_sec": steps * self.batch_size / dt}


def _device_batch(raw: dict, device: torch.device, generator: torch.Generator, out_size: int) -> dict:
    """Copy the host batch to the device and run the train transform there."""
    to = lambda a: torch.from_numpy(a).to(device, non_blocking=True)
    return destr_train_transform(
        to(raw["images"]), to(raw["boxes"]), to(raw["labels"]), to(raw["valid"]),
        generator, out_size=out_size,
    )


def _params_finite(model) -> bool:
    return bool(torch.stack([torch.isfinite(p).all() for p in model.parameters()]).all())


def train_destr(config: Config, device: str | torch.device | None = None) -> dict:
    """Train DESTR on ``device`` (the GPU unless "cpu" is asked for).

    Returns {"state", "metrics" (the last flushed means), "images_per_sec"
    (of the last epoch), "step_ms" (per step, CUDA events; empty on the CPU)}.
    """
    _refuse_later_slices(config)
    device = resolve_device(device)
    cfg_t = config.train
    data = config.data
    canvas = int(cfg_t.image_size * 672 / 640)  # reference eval geometry
    train_ds = build_dataset(
        data.dataset, data.root, "train", image_size=data.image_size,
        num_samples=data.num_train_samples, num_classes=1,
        max_items_per_img=data.max_targets, seed=cfg_t.seed,
    )
    loader = DetectionLoader(
        train_ds, batch_size=cfg_t.batch_size, canvas_size=canvas,
        max_targets=data.max_targets, augment_factor=data.augment_factor,
        shuffle=True, seed=cfg_t.seed,
    )
    torch.manual_seed(cfg_t.seed)  # the model's initial weights
    model = build_destr(config.destr, device)
    state = create_destr_state(model, cfg_t, steps_per_epoch=len(loader))
    train_step = make_destr_train_step(cfg_t)
    aug_gen = torch.Generator(device=device).manual_seed(cfg_t.seed + 7)

    logger = MetricLogger(cfg_t.log_dir)
    timer = StepTimer(cfg_t.batch_size, device)
    metrics, rate, means = None, {}, {}
    try:
        for epoch in range(cfg_t.epochs):
            t0 = time.time()
            timer.start()
            for step_in_epoch, raw in enumerate(loader):
                batch = _device_batch(raw, device, aug_gen, cfg_t.image_size)
                metrics = train_step(state, batch)
                timer.step()
                logger.accumulate(state.step, metrics)
                if (step_in_epoch + 1) % cfg_t.log_interval == 0:
                    means = logger.flush("train")
            means = logger.flush("train") or means
            if metrics is not None:
                rate = timer.stop()
                logger.scalar("Perf/images_per_sec", rate["images_per_sec"], state.step)
            if not _params_finite(model):
                print(f"FATAL: non-finite parameters after epoch {epoch} — training has diverged "
                      "past the --skip_nonfinite window. Halting.", flush=True)
                break
            print(f"epoch {epoch}: {time.time() - t0:.1f}s", flush=True)
    finally:
        logger.close()
    return {"state": state, "metrics": means, "images_per_sec": rate.get("images_per_sec"),
            "step_ms": timer.step_ms}
