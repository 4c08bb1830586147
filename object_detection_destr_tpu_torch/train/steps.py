"""The DESTR and SSD train and eval steps (port of
``object_detection_destr_tpu/train/steps.py``: ``_match_pair`` l.86-152,
``make_destr_train_step`` l.155-209, ``_guard_stats`` l.212-223,
``make_destr_eval_step`` l.226-252, ``flat_anchors`` l.255-261,
``make_ssd_train_step`` l.264-305, ``make_ssd_eval_step`` l.308-339).

One step: forward in train mode (batch-statistics BatchNorm, dropout from
the state's stream), one matcher launch for both criteria, the two set
criteria, backward, and the optimizer update (with ``grad_accum_steps`` k a
step is a mini-step: the optimizer folds its gradients into their running
mean and updates on every k-th, ``train/optim.py``). That device work is
:func:`make_destr_step_core`; it reads nothing back to the host, so a CUDA
graph can capture it (``train/epoch_scan.py``). :func:`make_destr_train_step`
wraps it with the host's bookkeeping: the dropout stream reseeded from the
step, and the step count. Loss wiring as the reference
(train.py:160-217):

    weighted = cost_class * class + cost_bbox * bbox + cost_ciou * ciou
    loss = 0.7 * weighted(model output) + 0.3 * weighted(mini-detector output)

and for SSD ``ssd_criterion``'s ``coef * class + (1 - coef) * local``
(train_ssd.py:108-134), the same core / wrapper split around it.

Every factory takes an optional data-parallel ``mesh`` (``parallel.Mesh``),
as JAX's take ``mesh=`` (steps.py:41-62): the batch is then this rank's rows
of the global batch and the step runs the collectives over the mesh, also
on a mesh of one rank. DESTR's criterion reduces over the global batch and
its gradients are summed (steps.py:195-202); SSD averages its gradients and
metrics (steps.py:290-298) and its eval step its losses (steps.py:333). The
all-reduce of the gradients sits between ``backward`` and the BatchNorm
guard and optimizer update, so the clip and the finite check see the global
gradient. On a mesh above one rank the dropout stream folds in the rank.
The eval steps return the model's outputs of the whole global batch, in
batch order (``out_specs=P("data")``), and the global losses. Without a
mesh a step is the single device's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..config import SSDConfig, TrainConfig
from ..geometry.boxes import default_boxes
from ..losses.criterion import _flatten_scales, set_criterion, ssd_criterion
from ..losses.matcher import decode_ssd_boxes
from ..ops.cuda.auction import hungarian_match_fused
from .state import TrainState

__all__ = [
    "flat_anchors",
    "make_destr_eval_step",
    "make_destr_step_core",
    "make_destr_train_step",
    "make_ssd_eval_step",
    "make_ssd_step_core",
    "make_ssd_train_step",
]


def _weighted(losses: dict, cfg: TrainConfig) -> torch.Tensor:
    """reduce_dict with the --set_cost_* weights (steps.py:73-79)."""
    return (
        cfg.set_cost_class * losses["class"]
        + cfg.set_cost_bbox * losses["bbox"]
        + cfg.set_cost_ciou * losses["ciou"]
    )


def _destr_targets(batch: dict) -> dict:
    return {"boxes": batch["boxes"], "labels": batch["labels"], "valid": batch["valid"]}


def _match_pair(model_out: dict, det_out: dict, targets: dict):
    """Matching for both criteria in ONE fused cost + auction launch
    (steps.py:112-140): the model's top-k queries and the mini-detector's
    HW tokens are padded to a common row count, stacked on the batch axis and
    told apart by a per-problem row-valid mask. The matcher's inputs are
    detached: no gradient goes through matching.

    This is the path of the JAX package's fused Pallas kernel (#9), on every
    device. (The JAX package's CPU path pads the model's cost rows with 1e6
    instead, which widens the auction's eps about 1e5-fold there; see
    ROADMAP.md.)"""
    b, n1 = model_out["pred_class"].shape[:2]
    n2 = det_out["pred_class"].shape[1]
    n = max(n1, n2)

    def pad_n(x, rows):
        return F.pad(x.detach().float(), (0, 0, 0, n - rows))

    logits = torch.cat([pad_n(model_out["pred_class"], n1), pad_n(det_out["pred_class"], n2)])
    boxes = torch.cat([pad_n(model_out["pred_boxes"], n1), pad_n(det_out["pred_boxes"], n2)])
    iota = torch.arange(n, device=logits.device)[None, :]
    row_valid = torch.cat([(iota < n1).expand(b, n), (iota < n2).expand(b, n)])
    twice = lambda t: torch.cat([t, t])
    rows = hungarian_match_fused(
        logits, boxes, twice(targets["boxes"].detach()), twice(targets["labels"]),
        twice(targets["valid"]), row_valid=row_valid,
    )
    return rows[:b], rows[b:]


def _bn_stats(model) -> dict[str, torch.Tensor]:
    return {name: buf for name, buf in model.named_buffers() if name.endswith(("running_mean", "running_var"))}


def _guard_stats(model, old_stats: dict, cfg: TrainConfig) -> None:
    """Keep BatchNorm running statistics finite when non-finite protection
    is on: an element that is not finite after the forward goes back to its
    old value (steps.py:212-223)."""
    if not cfg.skip_nonfinite_updates:
        return
    with torch.no_grad():
        for name, buf in _bn_stats(model).items():
            buf.copy_(torch.where(torch.isfinite(buf), buf, old_stats[name]))


def _pmean_metrics(metrics: dict, mesh) -> dict:
    """The metrics averaged over the mesh in one all-reduce (detached)."""
    if mesh is None:
        return metrics
    keys = list(metrics)
    total = mesh.all_reduce_(torch.stack([metrics[k].detach().float() for k in keys]))
    return dict(zip(keys, (total / mesh.size).unbind()))


def _gathered(tree, mesh):
    """A dict of tensors (or of lists of tensors), each with its leading
    axis gathered over the mesh in rank order."""
    if mesh is None:
        return tree
    return {k: [mesh.all_gather(t) for t in v] if isinstance(v, (list, tuple)) else mesh.all_gather(v)
            for k, v in tree.items()}


def make_destr_step_core(cfg: TrainConfig, mesh=None,
                         observer: Optional[Callable[[dict], None]] = None) -> Callable[[TrainState, dict], dict]:
    """``core(state, batch) -> metrics``: the device work of one step,
    updating the model and the optimizer in place and nothing on the host
    (not the step count; the dropout stream as the caller seeded it). With
    a ``mesh``, ``batch`` is this rank's rows and the metrics are the global
    batch's.

    ``batch``: {"images": (B, S, S, 3) float32 normalized, "boxes": (B, T, 4)
    xyxy, "labels": (B, T), "valid": (B, T) bool, optional "pixel_valid"}.
    Metrics are detached device scalars.

    ``observer``, where given, is called once a step after the update with
    what the step computed on the way, detached: {"model_out", "targets",
    "l_model", "l_det" (each criterion's unweighted components), "loss",
    "loss_model", "loss_det", "optimizer" (``AdamW.step``'s grad_norm,
    finite, applied)}. The gradients stay in the parameters' ``.grad`` until
    the next step. It reads; the step's values do not depend on it
    (``tools/postmortem_divergence_torch.py``).
    """

    def core(state: TrainState, batch: dict) -> dict:
        model = state.model
        old_stats = (
            {k: v.clone() for k, v in _bn_stats(model).items()} if cfg.skip_nonfinite_updates else None
        )
        state.optimizer.zero_grad()
        model_out, det_out = model(batch["images"], batch.get("pixel_valid"), train=True, rng=state.rng)
        targets = _destr_targets(batch)
        rows_model, rows_det = _match_pair(model_out, det_out, targets)
        l_model = set_criterion(model_out, targets, rows=rows_model, class_norm=cfg.class_norm, mesh=mesh)
        l_det = set_criterion(det_out, targets, rows=rows_det, class_norm=cfg.class_norm, mesh=mesh)
        loss_model = _weighted(l_model, cfg)
        loss_det = _weighted(l_det, cfg)
        loss = cfg.model_loss_weight * loss_model + cfg.det_loss_weight * loss_det
        loss.backward()
        if mesh is not None:
            # each rank's gradient is its data's share of the global loss'
            mesh.all_reduce_grads(model.parameters())
        _guard_stats(model, old_stats, cfg)
        update = state.optimizer.step()
        if observer is not None:
            detached = lambda tree: {k: v.detach() for k, v in tree.items()}
            observer({"model_out": detached(model_out), "targets": targets, "l_model": detached(l_model),
                      "l_det": detached(l_det), "loss": loss.detach(), "loss_model": loss_model.detach(),
                      "loss_det": loss_det.detach(), "optimizer": update})
        return {
            "loss": loss.detach(),
            "loss_model": loss_model.detach(),
            "loss_det": loss_det.detach(),
            "loss_class": l_model["class"].detach(),
            "loss_ciou": l_model["ciou"].detach(),
        }

    return core


def _step_wrapper(core: Callable[[TrainState, dict], dict], mesh=None) -> Callable[[TrainState, dict], dict]:
    """``train_step(state, batch) -> metrics``, updating ``state`` in place:
    the dropout stream reseeded for ``state.step`` (and the rank, on a mesh
    above one rank), ``core``'s device work, then ``state.step + 1``."""
    rank = None if mesh is None else mesh.fold_rank

    def train_step(state: TrainState, batch: dict) -> dict:
        state.rng.begin_step(state.step, rank)
        metrics = core(state, batch)
        state.step += 1
        return metrics

    return train_step


def make_destr_train_step(cfg: TrainConfig, mesh=None,
                          observer: Optional[Callable[[dict], None]] = None) -> Callable[[TrainState, dict], dict]:
    """:func:`make_destr_step_core` (with its ``observer``) wrapped with the
    step's host bookkeeping."""
    return _step_wrapper(make_destr_step_core(cfg, mesh, observer), mesh)


def make_destr_eval_step(cfg: TrainConfig, mesh=None) -> Callable[[TrainState, dict], tuple[dict, dict]]:
    """``eval_step(state, batch) -> (model_out, metrics)``.

    The model runs in eval mode (BatchNorm running statistics, no dropout)
    at its ``compute_dtype`` (bfloat16 by autocast, as in training), without
    gradients; one matcher launch for both criteria, then the two set
    criteria. Metrics: "loss_model", "loss_det" (weighted), "loss_class",
    "loss_ciou" (of the model output), detached device scalars. The model
    goes back to the mode it was in.
    """

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> tuple[dict, dict]:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            model_out, det_out = model(batch["images"], batch.get("pixel_valid"), train=False)
        finally:
            model.train(was_training)
        targets = _destr_targets(batch)
        rows_model, rows_det = _match_pair(model_out, det_out, targets)
        l_model = set_criterion(model_out, targets, rows=rows_model, class_norm=cfg.class_norm, mesh=mesh)
        l_det = set_criterion(det_out, targets, rows=rows_det, class_norm=cfg.class_norm, mesh=mesh)
        metrics = {
            "loss_model": _weighted(l_model, cfg),
            "loss_det": _weighted(l_det, cfg),
            "loss_class": l_model["class"],
            "loss_ciou": l_model["ciou"],
        }
        return _gathered(model_out, mesh), metrics

    return eval_step


def flat_anchors(ssd_cfg: SSDConfig, device: torch.device | str | None = None) -> torch.Tensor:
    """(S, 4) float32 default boxes flattened scale-major, the criterion's
    flatten order (steps.py:255-261), computed on ``device``."""
    per_scale = default_boxes(ssd_cfg.feature_shapes, ssd_cfg.scales, ssd_cfg.aspect_ratios, device)
    return torch.cat([a.reshape(-1, 4) for a in per_scale], dim=0)


def _anchors_on(ssd_cfg: SSDConfig) -> Callable[[torch.device], torch.Tensor]:
    """The default boxes on a device, made there at the first call (the
    runner's eager warm-up) and kept: a captured step recomputes nothing, and
    no step copies from the host."""
    placed: dict[torch.device, torch.Tensor] = {}

    def on(device: torch.device) -> torch.Tensor:
        if device not in placed:
            placed[device] = flat_anchors(ssd_cfg, device)
        return placed[device]

    return on


def make_ssd_step_core(cfg: TrainConfig, ssd_cfg: SSDConfig, mesh=None) -> Callable[[TrainState, dict], dict]:
    """``core(state, batch) -> metrics``: one SSD step's device work (forward
    in train mode, ``ssd_criterion`` with the config's mining, backward,
    update), as :func:`make_destr_step_core`. ``batch``: {"images": (B, S,
    S, 3) float32 normalized, "boxes": (B, T, 4) cxcyhw, "labels", "valid"}.
    Metrics {"loss", "class", "local"} are detached device scalars."""
    anchors = _anchors_on(ssd_cfg)

    def core(state: TrainState, batch: dict) -> dict:
        model = state.model
        old_stats = (
            {k: v.clone() for k, v in _bn_stats(model).items()} if cfg.skip_nonfinite_updates else None
        )
        state.optimizer.zero_grad()
        outputs = model(batch["images"], train=True)
        losses = ssd_criterion(outputs, _destr_targets(batch), anchors(batch["images"].device),
                               loss_coef=cfg.coef_class_loss, mining=ssd_cfg.hard_neg_mining)
        losses["loss"].backward()
        if mesh is not None:
            # SSD losses are per-image means, so the global loss is the pmean
            # of equal-size shard means
            mesh.all_reduce_grads(model.parameters(), mean=True)
        _guard_stats(model, old_stats, cfg)
        state.optimizer.step()
        return _pmean_metrics({k: v.detach() for k, v in losses.items()}, mesh)

    return core


def make_ssd_train_step(cfg: TrainConfig, ssd_cfg: SSDConfig, mesh=None) -> Callable[[TrainState, dict], dict]:
    """:func:`make_ssd_step_core` wrapped with the step's host bookkeeping."""
    return _step_wrapper(make_ssd_step_core(cfg, ssd_cfg, mesh), mesh)


def make_ssd_eval_step(cfg: TrainConfig, ssd_cfg: SSDConfig, mesh=None) -> Callable[[TrainState, dict], tuple]:
    """``eval_step(state, batch) -> (outputs, losses, detections)``: the
    model in eval mode (running statistics) without gradients, its
    ``ssd_criterion`` losses, and the detections in the metric's contract,
    {"pred_class": (B, S, C+1) logits, "pred_boxes": (B, S, 4) cxcyhw
    decoded}. The model goes back to the mode it was in."""
    anchors = _anchors_on(ssd_cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> tuple[dict, dict, dict]:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            outputs = model(batch["images"], train=False)
        finally:
            model.train(was_training)
        flat = anchors(batch["images"].device)
        losses = ssd_criterion(outputs, _destr_targets(batch), flat, loss_coef=cfg.coef_class_loss,
                               mining=ssd_cfg.hard_neg_mining)
        detections = {"pred_class": _flatten_scales(outputs["conf"]),
                      "pred_boxes": decode_ssd_boxes(_flatten_scales(outputs["boxes"]), flat)}
        return _gathered(outputs, mesh), _pmean_metrics(losses, mesh), _gathered(detections, mesh)

    return eval_step
