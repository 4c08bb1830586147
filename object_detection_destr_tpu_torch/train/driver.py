"""The DESTR and SSD training loops with validation, checkpoints and resume
(port of ``object_detection_destr_tpu/train/driver.py``: ``_halt_diverged``,
``_try_save``, ``_make_ema``, ``_make_loaders`` l.84-197, ``train_destr``
l.219-461 and ``train_ssd`` l.464-660). The two trainers share one epoch
loop (:func:`_fit`); what differs is their :class:`_Run`: the model, steps
and transforms, the validation sweep (SSD's stretches instead of
letterboxing, scores the decoded detections against xyxy targets over its
``num_cls`` classes and has no COCO AP), the augmentation seed offset (7 and
13, as the JAX drivers' keys), the loss that picks the best checkpoint
(``loss_model`` and ``loss``) and, for DESTR only, ``profile_dir`` (the JAX
SSD driver has none).

Per epoch: batches from the train loader, the train transform on the model's
device (its draws from a generator seeded from ``(seed + offset, step)``
each step, as the JAX driver folds the step into its key, so a resumed run draws
what the uninterrupted one did; the dropout stream is reseeded from the step
the same way), one train step each and, with ``ema_decay``, one update of
the parameter EMA. With ``device_cache`` both loaders serve their batches
from device memory (``data/device_cache.py``); with ``epoch_scan`` as well,
an epoch is the replays of one CUDA-graph-captured step of gather, transform,
step and EMA (``train/epoch_scan.py``; ``epoch_scan`` without
``device_cache`` is ignored with a notice, as in the JAX driver). With
``profile_dir`` (which turns ``epoch_scan`` off, as in JAX) steps 2-4 of the
first epoch are traced (``train/profiler.py``) and the trace's device busy
time and idle share printed; the running mean of the step
metrics every ``log_interval`` steps (``[train step N] loss=...``, and
``log_dir/metrics.jsonl``), then ``Perf/images_per_sec``. Every
``val_interval`` epochs and at the last one, a validation sweep (the eval
transform, the eval step, the reference mAP and, with ``coco_eval``, COCO
AP; tags ``Loss/valid/*``, ``Metric/mAP``, ``Metric/coco_mAP``) and with the
EMA a second one on the EMA parameters with the live BatchNorm statistics
(``Loss/valid_ema/*``, ``Metric/ema_mAP``, ``Metric/ema_coco_mAP``). The
run halts before any save when the parameters stop being finite. Checkpoints
(``train/checkpoint.py``): ``save_as`` on the lowest validation loss,
``save_as_ema`` on the lowest EMA one, ``save_as_last`` after every validated epoch and every ``save_interval`` epochs, and
``save_as_interrupt`` on ``KeyboardInterrupt``. ``resume`` restores
``resume_from`` and runs ``epochs`` more epochs.

The JAX package's training options: ``grad_accum_steps`` (the optimizer
accumulates k mini-steps an update, ``train/optim.py``; a step of the loop,
of the log and of the step count is a mini-step, as in JAX), ``letterbox``
(the train loader letterboxes and the train transform crops inside each
image's content and hands the model its ``pixel_valid`` mask, eager and
through the device cache and the epoch runner), ``moment_dtype`` and
``opt_layout`` (``train/optim.py``). ``rng_impl`` names a JAX PRNG for the
dropout stream; the port's dropout draws from :class:`~..models.destr.layers.
DropoutRng`'s Philox generator whatever it says, so both of its values are
accepted and change nothing, and JAX command lines run unchanged. Metrics
go to stdout, ``log_dir/metrics.jsonl`` and TensorBoard
(``train/logging_utils.py``).

Data parallelism (driver.py:42-47, 219-260, 464-497): a trainer runs over a
mesh (``parallel/mesh.py``), by default the launcher's world cut to the
largest rank count that divides the batch (``auto_mesh``; ranks beyond it
sit idle and return at once), or ``num_data_shards`` ranks. On one rank the
single device's path runs unchanged; above one, as JAX's ``step_mesh``,
the loaders make each rank's rows of the global batch (``batch_size`` stays
global), the eager augmentation draws the global batch's values and keeps
the rank's, the steps reduce over the mesh with the BatchNorms synced
(``bn_axis_name="data"``), and the epoch runner replays each rank's columns.
The parameters stay replicated, so every rank takes the same divergence
halt. Rank 0 alone prints, writes ``metrics.jsonl`` and TensorBoard, saves
the checkpoints and traces under ``profile_dir``; the others wait for its
writes at a barrier. Validation gathers each batch's outputs and targets to
every rank, so its mAP and COCO AP are one process's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from ..config import Config, resolve_device
from ..data import DetectionLoader, build_dataset
from ..data.device_cache import DeviceCachedLoader
from ..data.transforms import destr_eval_transform, destr_train_transform, ssd_eval_transform, ssd_train_transform
from ..geometry.boxes import cxcyhw_to_xyxy
from ..losses.metrics import CocoAveragePrecision, MeanAveragePrecision
from ..models.destr.model import build_destr
from ..models.ssd.model import build_ssd
from ..parallel.mesh import Mesh, auto_mesh, make_mesh
from .checkpoint import restore_checkpoint, save_checkpoint
from .epoch_scan import EpochRunner
from .logging_utils import MetricLogger
from .profiler import StepTimer, StepTrace, parse_trace
from .state import TrainState, create_destr_state, create_ssd_state
from .steps import (
    make_destr_eval_step,
    make_destr_step_core,
    make_destr_train_step,
    make_ssd_eval_step,
    make_ssd_step_core,
    make_ssd_train_step,
)

__all__ = ["train_destr", "train_ssd", "MetricLogger", "StepTimer"]


def _quiet(*args, **kwargs) -> None:
    """``print`` on a rank other than 0."""


def _default_mesh(cfg_t, device) -> Mesh:
    """num_data_shards > 1 pins the data-axis size; otherwise the largest
    rank count dividing the batch is used (driver.py:42-47)."""
    if cfg_t.num_data_shards > 1:
        return make_mesh(num_data=cfg_t.num_data_shards, device=device)
    return auto_mesh(cfg_t.batch_size, device=device)


def _to_device(raw: dict, device: torch.device) -> dict:
    """A host batch (numpy) copied to ``device``; a cached one (tensors on
    the device) as it is."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v)).to(device, non_blocking=True)
            for k, v in raw.items()}


def _eval_batch(raw: dict, device: torch.device, resize_to: int, out_size: int) -> dict:
    """Copy the host batch to the device and run the eval transform there
    (over the letterboxed content where the loader gives its extents)."""
    b = _to_device(raw, device)
    return destr_eval_transform(b["images"], b["boxes"], b["labels"], b["valid"], b.get("content_hw"),
                                resize_to=resize_to, out_size=out_size)


def _aug_seed(seed: int, step: int, offset: int = 7) -> int:
    """The train transform's seed at a step: a pure function of (seed +
    offset, step), as ``fold_in(key(seed + offset), step)`` is in the JAX
    drivers (offset 7 for DESTR, 13 for SSD)."""
    return (seed + offset) * 1_000_003 + step


def _params_finite(model) -> bool:
    return bool(torch.stack([torch.isfinite(p).all() for p in model.parameters()]).all())


def _halt_diverged(save_as: str, epoch: int) -> None:
    print(
        f"FATAL: non-finite parameters after epoch {epoch} — training has diverged past the "
        "--skip_nonfinite window (the update is applied after that many rejections in a row). "
        f"Halting without overwriting checkpoints; resume from '{save_as}' (best) or "
        f"'{save_as}_last' with a lower lr.",
        flush=True,
    )


def _try_save(mesh: Mesh, *args) -> None:
    """Per-epoch checkpoint write that cannot kill the run: a failure costs
    one checkpoint, the next epoch writes again. The interrupt handler saves
    unguarded. Rank 0 writes; every rank waits for it at a barrier."""
    if mesh.is_main:
        try:
            save_checkpoint(*args)
        except Exception as e:  # noqa: BLE001 — deliberate catch-all at the epoch boundary
            print(f"WARNING: checkpoint save failed ({type(e).__name__}: {e}); "
                  "continuing — next epoch will retry", flush=True)
    mesh.barrier()


def _make_ema(decay: float):
    """(init, update) for a per-step EMA of the parameters (driver.py:110-127):
    ``init(model)`` copies them, ``update(ema, model)`` sets
    ``ema = decay * ema + (1 - decay) * params`` in place. Parameters only:
    BatchNorm statistics are buffers and stay live."""

    def init(model) -> list[torch.Tensor]:
        return [p.detach().clone() for p in model.parameters()]

    @torch.no_grad()
    def update(ema: list[torch.Tensor], model) -> list[torch.Tensor]:
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [p.detach() for p in model.parameters()], alpha=1.0 - decay)
        return ema

    return init, update


@contextlib.contextmanager
def _parameters_swapped(model, values: list[torch.Tensor]):
    """Run the body with ``values`` in the model's parameters (the EMA
    sweep's ``state.replace(params=ema_params)``), the live ones back after."""
    params = list(model.parameters())
    live = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(v)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, v in zip(params, live):
                p.copy_(v)


def _make_loaders(config: Config, canvas: int, for_train_model: str = "destr", mesh=None):
    """The train and valid loaders of the JAX driver (driver.py:130-197),
    each making this rank's rows of a global batch on a data-parallel
    ``mesh``:
    under letterbox training or letterbox eval the synthetic set emits the
    aspect ratios (1.0, 0.7, 1.4); the valid split's dataset seed is
    ``seed + 10_000`` (``build_dataset``); the valid loader augments once,
    shuffles with ``seed + 1`` and, for DESTR, letterboxes at eval. SSD's
    sets have ``ssd.num_cls`` classes and never letterbox (its reference
    stretches, and its model has no pixel-mask input)."""
    data = config.data
    num_classes = {"destr": 1, "ssd": config.ssd.num_cls}[for_train_model]
    is_destr = for_train_model == "destr"
    train_letterbox = config.train.letterbox and is_destr
    eval_letterbox = (config.train.letterbox or config.train.letterbox_eval) and is_destr
    aspects = (1.0, 0.7, 1.4) if (train_letterbox or eval_letterbox) and data.dataset == "synthetic" else (1.0,)
    valid_split = {"widerface": "val", "coco": "val2017"}.get(data.dataset, "valid")
    datasets = [
        build_dataset(data.dataset, data.root, split, image_size=data.image_size, num_samples=n,
                      num_classes=num_classes, max_items_per_img=data.max_targets, seed=config.train.seed,
                      aspect_ratios=aspects)
        for split, n in (("train", data.num_train_samples), (valid_split, data.num_valid_samples))
    ]
    common = dict(batch_size=config.train.batch_size, canvas_size=canvas, max_targets=data.max_targets,
                  mesh=mesh)
    train_loader = DetectionLoader(datasets[0], augment_factor=data.augment_factor, shuffle=True,
                                   seed=config.train.seed, letterbox=train_letterbox, **common)
    # the reference shuffles the val loader too (train.py:284-290)
    valid_loader = DetectionLoader(datasets[1], augment_factor=1, shuffle=True, seed=config.train.seed + 1,
                                   letterbox=eval_letterbox, **common)
    return train_loader, valid_loader


_PROFILE_STEPS = (2, 4)  # the first and last step of epoch 0 traced under profile_dir (JAX driver.py:354-367)


def _profile_summary(path: str) -> dict:
    """The parsed trace, printed: device busy seconds and idle share of the
    window and of each traced step."""
    parsed = parse_trace(path)
    steps = ", ".join(f"{s['label']}: busy {s['busy_s'] * 1e3:.2f} ms of {s['period_s'] * 1e3:.2f}"
                      for s in parsed["steps"])
    print(f"profile: {path}: device busy {parsed['busy_s'] * 1e3:.2f} ms of a {parsed['window_s'] * 1e3:.2f} ms "
          f"window, idle share {parsed['idle_share']:.4f}; steps {steps}", flush=True)
    return {"path": path, **parsed}


def _device_cached(train_loader, valid_loader, device: torch.device, say=print):
    """Both loaders served from device memory (``--device_cache``), and the
    caches' bytes and build seconds, printed (``say``)."""
    train_loader = DeviceCachedLoader(train_loader, device)
    valid_loader = DeviceCachedLoader(valid_loader, device)
    info = {name: {"bytes": c.nbytes, "build_seconds": c.build_seconds}
            for name, c in (("train", train_loader), ("valid", valid_loader))}
    say("device cache: " + ", ".join(f"{name} {v['bytes'] / 1e9:.3f} GB in {v['build_seconds']:.1f} s"
                                     for name, v in info.items()), flush=True)
    return train_loader, valid_loader, info


def _gathered_targets(batch: dict, mesh) -> dict:
    """The batch's targets, of the whole global batch on a mesh."""
    return {k: batch[k] if mesh is None else mesh.all_gather(batch[k]) for k in ("boxes", "labels", "valid")}


def _val_sweep(state, loader, eval_step, metric: MeanAveragePrecision,
               coco_metric: Optional[CocoAveragePrecision], device: torch.device, resize_to: int,
               out_size: int, mesh=None, on_batch: Optional[Callable[[dict, dict, dict], None]] = None
               ) -> tuple[dict, float, Optional[float], float]:
    """One validation pass over ``loader``'s raw batches (driver.py:298-323):
    (the means of the eval step's metrics, mAP, COCO AP or None, host
    seconds; the last batch's metric update waits for the device). On a
    ``mesh`` the eval step gives the global batch's outputs and the targets
    are gathered, so the metrics are one process's. ``on_batch(outputs,
    targets, metric_state)``, where given, sees each batch after the metrics'
    updates (``tools/val_noise_torch.py`` reads per-image records there)."""
    t0 = time.perf_counter()
    metric_state = metric.init_state()
    if coco_metric is not None:
        coco_metric.reset()
    val_metrics: list = []
    for raw in loader:
        batch = _eval_batch(raw, device, resize_to, out_size)
        outputs, m = eval_step(state, batch)
        targets = _gathered_targets(batch, mesh)
        metric_state = metric.update(metric_state, outputs, targets)
        if coco_metric is not None:
            coco_metric.update(outputs, targets)
        if on_batch is not None:
            on_batch(outputs, targets, metric_state)
        val_metrics.append(m)
    val_means = {k: float(torch.stack([m[k] for m in val_metrics]).float().mean())
                 for k in val_metrics[0]} if val_metrics else {}
    coco_val = coco_metric.compute() if coco_metric is not None else None
    return val_means, metric.compute(metric_state), coco_val, time.perf_counter() - t0


def _ssd_val_sweep(state, loader, eval_step, metric: MeanAveragePrecision, device: torch.device,
                   out_size: int, mesh=None) -> tuple[dict, float, None, float]:
    """SSD's validation pass (driver.py:529-554): the stretch eval transform,
    the eval step, and the reference mAP of its decoded detections against
    the targets in xyxy, gathered over a ``mesh``; (loss means, mAP, None,
    host seconds)."""
    t0 = time.perf_counter()
    metric_state = metric.init_state()
    val_metrics: list = []
    for raw in loader:
        b = _to_device(raw, device)
        batch = ssd_eval_transform(b["images"], b["boxes"], b["labels"], b["valid"], out_size=out_size)
        _, m, detections = eval_step(state, batch)
        targets = _gathered_targets(batch, mesh)
        metric_state = metric.update(metric_state, detections, {**targets, "boxes": cxcyhw_to_xyxy(targets["boxes"])})
        val_metrics.append(m)
    val_means = {k: float(torch.stack([m[k] for m in val_metrics]).float().mean())
                 for k in val_metrics[0]} if val_metrics else {}
    return val_means, metric.compute(metric_state), None, time.perf_counter() - t0


@dataclasses.dataclass
class _Run:
    """What one trainer gives the shared epoch loop :func:`_fit`."""

    state: TrainState
    train_step: Callable[[TrainState, dict], dict]  # the per-step path
    step_core: Callable[[TrainState, dict], dict]  # the captured path's body
    transform: Callable[..., dict]  # (device batch, draws[, mesh: the global batch's draws]) -> model batch
    sweep: Callable[[], tuple]  # one validation pass of ``state``: (means, mAP, COCO or None, seconds)
    aug_offset: int  # the augmentation seed's offset (_aug_seed)
    val_key: str  # the validation loss that picks the best checkpoints
    val_label: str  # its name in the epoch line
    profile_dir: Optional[str]  # trace steps 2-4 of epoch 0 here (and run per step)
    mesh: Mesh  # the run's mesh (of one rank on a single device)
    step_mesh: Optional[Mesh]  # the mesh the steps reduce over: None on one rank (JAX's step_mesh)

    def eager_step(self, raw: dict, device: torch.device, gen: torch.Generator, seed: int) -> dict:
        """One step of the per-step loop: the transform's generator reseeded
        for the step (:func:`_aug_seed` of ``seed``), the batch on the device
        through the train transform, the train step; returns its metrics."""
        gen.manual_seed(_aug_seed(seed, self.state.step, self.aug_offset))
        batch = self.transform(_to_device(raw, device), gen, self.step_mesh)
        return self.train_step(self.state, batch)


def _fit(config: Config, device: torch.device, run: _Run, train_loader, cache_info) -> dict:
    """The epoch loop of both trainers (driver.py:325-461, 556-660); see the
    module doc. Returns {"state", "best_val", "map" (of the last sweep),
    "metrics" (the last flushed train means), "images_per_sec" (of the last
    epoch), "step_ms" (per step, CUDA events; empty on the CPU), "history"
    (per validated epoch: its scalars and the host seconds of each sweep),
    "device_cache" (bytes and build seconds of each split's cache, or None),
    "epoch_scan" (whether epochs ran as captured steps), "profile" (the
    parsed trace under profile_dir, or None)}."""
    cfg_t = config.train
    state, model = run.state, run.state.model
    main = run.mesh.is_main
    say = print if main else _quiet
    logger = MetricLogger(cfg_t.log_dir if main else None, echo=main)
    best_val = math.inf
    if cfg_t.resume:
        restored = restore_checkpoint(cfg_t.checkpoint_dir, cfg_t.resume_from, state)
        train_loader.load_state_dict(restored["loader"])
        best_val = restored["best_val"]
    aug_gen = torch.Generator(device=device)
    aug_seed = lambda step: _aug_seed(cfg_t.seed, step, run.aug_offset)

    ema_params = None
    if cfg_t.ema_decay:
        ema_init, ema_update = _make_ema(cfg_t.ema_decay)
        ema_params = ema_init(model)  # a resume seeds the EMA from the restored parameters
        best_ema_val = math.inf

    epoch_runner = None
    if cfg_t.epoch_scan and not run.profile_dir:  # profiling needs per-step
        if not config.data.device_cache:
            say("epoch_scan ignored: requires --device_cache", flush=True)
        else:
            epoch_runner = EpochRunner(
                state, run.step_core, run.transform, train_loader.data, aug_seed, len(train_loader),
                ema=None if ema_params is None else (ema_params, ema_update), mesh=run.step_mesh,
            )
    trace, profile = None, None

    timer = StepTimer(cfg_t.batch_size, device)
    metrics, rate, means, last_map, history = None, {}, {}, 0.0, []
    try:
        for epoch in range(cfg_t.epochs):
            t0 = time.time()
            # ---- train ----
            metrics = None
            timer.start()
            if epoch_runner is not None:
                # ---- captured steps (train/epoch_scan.py), metrics read once
                base_step = state.step
                _, idx = train_loader.epoch_index_matrix()
                fetched = epoch_runner.run(idx, base_step, after_step=timer.step)
                for i in range(idx.shape[0]):
                    metrics = {k: torch.tensor(v[i]) for k, v in fetched.items()}
                    logger.accumulate(base_step + i + 1, metrics)
                    if (i + 1) % cfg_t.log_interval == 0:
                        means = logger.flush("train")
                train_loader.advance_epoch()
            else:
                for step_in_epoch, raw in enumerate(train_loader):
                    if run.profile_dir and main and epoch == 0 and step_in_epoch == _PROFILE_STEPS[0]:
                        trace = StepTrace(run.profile_dir)
                        trace.start()
                    with trace.step(state.step) if trace is not None else contextlib.nullcontext():
                        metrics = run.eager_step(raw, device, aug_gen, cfg_t.seed)
                        if ema_params is not None:
                            ema_update(ema_params, model)
                    timer.step()
                    if trace is not None and step_in_epoch == _PROFILE_STEPS[1]:
                        profile = _profile_summary(trace.stop())
                        trace = None
                    logger.accumulate(state.step, metrics)
                    if (step_in_epoch + 1) % cfg_t.log_interval == 0:
                        means = logger.flush("train")
                if trace is not None:  # an epoch shorter than the traced range
                    profile = _profile_summary(trace.stop())
                    trace = None
            means = logger.flush("train") or means
            if metrics is not None:
                rate = timer.stop()
                logger.scalar("Perf/images_per_sec", rate["images_per_sec"], state.step)

            # ---- validate ----
            do_val = (epoch + 1) % max(cfg_t.val_interval, 1) == 0 or epoch == cfg_t.epochs - 1
            val_loss = ema_val_loss = None
            if do_val:
                val_means, last_map, coco_val, seconds = run.sweep()
                record = {"epoch": epoch, "step": state.step, "valid": val_means, "mAP": last_map,
                          "coco_mAP": coco_val, "seconds": [seconds]}
                for k, v in val_means.items():
                    logger.scalar(f"Loss/valid/{k}", v, state.step)
                logger.scalar("Metric/mAP", last_map, state.step)
                if coco_val is not None:
                    logger.scalar("Metric/coco_mAP", coco_val, state.step)
                if ema_params is not None:
                    with _parameters_swapped(model, ema_params):
                        ema_means, ema_map, ema_coco, seconds = run.sweep()
                    record.update(valid_ema=ema_means, ema_mAP=ema_map, ema_coco_mAP=ema_coco)
                    record["seconds"].append(seconds)
                    for k, v in ema_means.items():
                        logger.scalar(f"Loss/valid_ema/{k}", v, state.step)
                    logger.scalar("Metric/ema_mAP", ema_map, state.step)
                    if ema_coco is not None:
                        logger.scalar("Metric/ema_coco_mAP", ema_coco, state.step)
                    ema_val_loss = ema_means.get(run.val_key, math.inf)
                val_loss = val_means.get(run.val_key, math.inf)
                history.append(record)

            # ---- divergence halt: never checkpoint non-finite parameters
            if not _params_finite(model):  # the same on every rank: the parameters are replicated
                if main:
                    _halt_diverged(cfg_t.save_as, epoch)
                break

            # ---- best checkpoint on the lowest val loss (train.py:123-128)
            if val_loss is not None and val_loss < best_val:
                best_val = val_loss
                _try_save(run.mesh, cfg_t.checkpoint_dir, cfg_t.save_as, state, train_loader.state_dict(), best_val)
            if ema_val_loss is not None and ema_val_loss < best_ema_val:
                best_ema_val = ema_val_loss
                with _parameters_swapped(model, ema_params):
                    _try_save(run.mesh, cfg_t.checkpoint_dir, cfg_t.save_as + "_ema", state,
                              train_loader.state_dict(), best_ema_val)
            if do_val or (epoch + 1) % max(cfg_t.save_interval, 1) == 0 or epoch == cfg_t.epochs - 1:
                _try_save(run.mesh, cfg_t.checkpoint_dir, cfg_t.save_as + "_last", state,
                          train_loader.state_dict(), best_val)
            ema_note = f" ema_val={ema_val_loss:.4f} ema_mAP={ema_map:.4f}" if ema_val_loss is not None else ""
            val_note = f" {run.val_label}={val_loss:.4f} mAP={last_map:.4f}" if do_val else ""
            say(f"epoch {epoch}: {time.time() - t0:.1f}s{val_note}{ema_note}", flush=True)
    except KeyboardInterrupt:
        # crash / preemption recovery: a resumable checkpoint before exiting
        if main:
            save_checkpoint(cfg_t.checkpoint_dir, cfg_t.save_as + "_interrupt", state,
                            train_loader.state_dict(), best_val)
            print(f"interrupted: checkpoint saved as {cfg_t.save_as}_interrupt", flush=True)
        raise
    finally:
        logger.close()
    return {"state": state, "best_val": best_val, "map": last_map, "metrics": means,
            "images_per_sec": rate.get("images_per_sec"), "step_ms": timer.step_ms, "history": history,
            "device_cache": cache_info, "epoch_scan": epoch_runner is not None, "profile": profile}


def _mesh_of(config: Config, device, mesh: Optional[Mesh]) -> tuple[Mesh, Optional[Mesh], torch.device]:
    """(the run's mesh, the steps' mesh, the device): ``mesh`` or the
    default one (:func:`_default_mesh`); the steps' is None on one rank
    (driver.py:225, 468)."""
    if mesh is None:
        mesh = _default_mesh(config.train, resolve_device(device))
    return mesh, (mesh if mesh.size > 1 else None), mesh.device


def _idle(mesh: Mesh) -> dict:
    print(f"rank outside the {mesh.size}-rank data axis: idle", flush=True)
    return {"state": None, "idle": True}


def train_destr(config: Config, device: str | torch.device | None = None, mesh: Optional[Mesh] = None) -> dict:
    """Train and validate DESTR on ``device`` (the GPU unless "cpu" is asked
    for) over ``mesh`` (default: :func:`_default_mesh`; its device is the
    run's); returns :func:`_fit`'s dict, or {"state": None, "idle": True}
    on a rank outside the data axis."""
    mesh, step_mesh, device = _mesh_of(config, device, mesh)
    if not mesh.active:
        return _idle(mesh)
    return _fit(config, device, *_destr_run(config, mesh, step_mesh, device))


def _destr_run(config: Config, mesh: Mesh, step_mesh: Optional[Mesh], device: torch.device,
               observer: Optional[Callable[[dict], None]] = None):
    """(the DESTR trainer's :class:`_Run`, its train loader, the device
    cache's info or None): the loaders, the model from the seed, the state
    and the steps of :func:`train_destr`; ``observer`` goes to the per-step
    path's train step (``make_destr_train_step``)."""
    cfg_t = config.train
    destr_cfg = dataclasses.replace(config.destr, bn_axis_name="data") if step_mesh is not None else config.destr
    canvas = int(cfg_t.image_size * 672 / 640)  # reference eval geometry
    train_loader, valid_loader = _make_loaders(config, canvas, "destr", step_mesh)
    cache_info = None
    if config.data.device_cache:
        train_loader, valid_loader, cache_info = _device_cached(train_loader, valid_loader, device,
                                                                print if mesh.is_main else _quiet)
    torch.manual_seed(cfg_t.seed)  # the model's initial weights, the same on every rank
    model = build_destr(destr_cfg, device, mesh=step_mesh)
    state = create_destr_state(model, cfg_t, steps_per_epoch=len(train_loader))
    metric = MeanAveragePrecision(num_cls=1, num_pred=config.destr.top_k)
    coco_metric = CocoAveragePrecision(num_cls=max(config.destr.num_cls - 1, 1)) if cfg_t.coco_eval else None
    out_size = cfg_t.image_size
    sweep = (state, valid_loader, make_destr_eval_step(cfg_t, step_mesh), metric, coco_metric, device, canvas,
             out_size, step_mesh)
    run = _Run(
        state, make_destr_train_step(cfg_t, step_mesh, observer), make_destr_step_core(cfg_t, step_mesh),
        lambda raw, gen, mesh=None: destr_train_transform(
            raw["images"], raw["boxes"], raw["labels"], raw["valid"], gen, raw.get("content_hw"),
            out_size=out_size, mesh=mesh),
        lambda: _val_sweep(*sweep), aug_offset=7, val_key="loss_model", val_label="val_model",
        profile_dir=cfg_t.profile_dir, mesh=mesh, step_mesh=step_mesh,
    )
    return run, train_loader, cache_info


def train_ssd(config: Config, device: str | torch.device | None = None, mesh: Optional[Mesh] = None) -> dict:
    """Train and validate SSD on ``device`` (the GPU unless "cpu" is asked
    for) over ``mesh`` (as :func:`train_destr`), at ``config.ssd``'s size on
    canvases of ``1.28 x`` it (the random patch's headroom); returns
    :func:`_fit`'s dict. ``profile_dir`` is not read, as in the JAX SSD
    driver."""
    mesh, step_mesh, device = _mesh_of(config, device, mesh)
    if not mesh.active:
        return _idle(mesh)
    cfg_t = config.train
    ssd_cfg = dataclasses.replace(config.ssd, bn_axis_name="data") if step_mesh is not None else config.ssd
    canvas = int(ssd_cfg.image_size * 1.28)
    train_loader, valid_loader = _make_loaders(config, canvas, "ssd", step_mesh)
    cache_info = None
    if config.data.device_cache:
        train_loader, valid_loader, cache_info = _device_cached(train_loader, valid_loader, device,
                                                                print if mesh.is_main else _quiet)
    torch.manual_seed(cfg_t.seed)  # the model's initial weights, the same on every rank
    model = build_ssd(ssd_cfg, device, mesh=step_mesh)
    state = create_ssd_state(model, cfg_t, steps_per_epoch=len(train_loader))
    eval_step = make_ssd_eval_step(cfg_t, ssd_cfg, step_mesh)
    metric = MeanAveragePrecision(num_cls=ssd_cfg.num_cls)
    out_size = ssd_cfg.image_size
    run = _Run(
        state, make_ssd_train_step(cfg_t, ssd_cfg, step_mesh), make_ssd_step_core(cfg_t, ssd_cfg, step_mesh),
        lambda raw, gen, mesh=None: ssd_train_transform(raw["images"], raw["boxes"], raw["labels"], raw["valid"],
                                                        gen, out_size=out_size, mesh=mesh),
        lambda: _ssd_val_sweep(state, valid_loader, eval_step, metric, device, out_size, step_mesh),
        aug_offset=13, val_key="loss", val_label="val", profile_dir=None, mesh=mesh, step_mesh=step_mesh,
    )
    return _fit(config, device, run, train_loader, cache_info)
