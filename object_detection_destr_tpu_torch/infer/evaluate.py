"""Standalone DESTR and SSD evaluation (port of
``object_detection_destr_tpu/infer/evaluate.py``: ``_batch_diagnostics``
l.44-78, ``evaluate_destr`` l.81-160, ``evaluate_ssd`` l.163-248, ``main``
l.251-270).

Evaluates a saved checkpoint on the validation split of the trainer's
configuration without training: the reference 11-point mAP and COCO AP, and
diagnostics that tell the three ways a detector can score zero apart —
classification confidence (does any query become argmax-foreground, the
reference metric's selection rule), score ranking (do sigmoid scores order
objects above clutter) and the localization ceiling (for each ground truth,
the best IoU over all predictions).

Usage (the trainer's flags, geometry included; the GPU unless ``--device
cpu``)::

    python -m object_detection_destr_tpu_torch.infer.evaluate \\
        --resume_from model_weights_last --checkpoint_dir checkpoints \\
        --dataset synthetic --synthetic_size 672 --num_valid_samples 256 \\
        --image_size 640 --batch_size 8 --top_k 300 [--no-letterbox_eval]

``--model ssd`` evaluates an SSD checkpoint on the SSD driver's validation
sweep, with the SSD trainer's flags. Prints one JSON line with metrics and
diagnostics.

Both sweeps run their step as CUDA-graph replays on the GPU
(``train/steps.py::CapturedEvalStep``, the counterpart of JAX's ``jax.jit``
of the forward and the eval step) and update the metrics on the device
(``losses/metrics.py``).

Under a launcher (``torchrun``; ``parallel/mesh.py::launched``) the sweep
runs over ``auto_mesh(batch_size)`` (evaluate.py:83-111, 175-206): each rank
evaluates its rows of every batch and the outputs and targets are gathered
before scoring, so the metrics are one process's; rank 0 prints them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..data.transforms import ssd_eval_transform
from ..geometry.boxes import cxcyhw_to_xyxy, pairwise_iou
from ..losses.metrics import CocoAveragePrecision, MeanAveragePrecision
from ..models.destr.model import build_destr
from ..models.ssd.model import build_ssd
from ..parallel.mesh import auto_mesh, launched
from ..train.arg_parser import config_from_args, get_parser
from ..train.checkpoint import restore_for_inference
from ..train.driver import _eval_batch, _gathered_targets, _make_loaders, _to_device
from ..train.state import TrainState
from ..train.steps import CapturedEvalStep, _gathered, make_ssd_eval_step

__all__ = ["evaluate_destr", "evaluate_ssd", "main"]


def _batch_diagnostics(outputs: dict, targets: dict) -> dict:
    """Host-side per-batch prediction statistics (small arrays, numpy)."""
    logits = np.asarray(outputs["pred_class"], np.float32)  # (B, N, C)
    pred_xyxy = cxcyhw_to_xyxy(torch.as_tensor(np.asarray(outputs["pred_boxes"], np.float32)))
    gt = torch.as_tensor(np.asarray(targets["boxes"], np.float32))
    gt_valid = np.asarray(targets["valid"], bool)

    sig0 = 1.0 / (1.0 + np.exp(-logits[..., 0]))  # (B, N) class-0 sigmoid
    argmax0 = logits.argmax(-1) == 0  # the reference metric's selection rule

    iou = pairwise_iou(pred_xyxy, gt).numpy()  # (B, N, T)
    best_iou_per_gt = iou.max(axis=1)  # (B, T)
    # the IoU of the top-scoring prediction with its best valid ground truth,
    # per image, over the images that have one
    top_pred = sig0.argmax(-1)  # (B,)
    top_iou = iou[np.arange(iou.shape[0]), top_pred]  # (B, T)
    img_has_gt = gt_valid.any(-1)  # (B,)
    top_iou_best = np.where(gt_valid, top_iou, -1.0).max(-1)  # (B,)

    sel = gt_valid
    return {
        "n_gt": int(sel.sum()),
        "sum_best_iou": float(best_iou_per_gt[sel].sum()),
        "n_gt_localized": int((best_iou_per_gt[sel] >= 0.5).sum()),
        "sum_top_iou": float(top_iou_best[img_has_gt].sum()),
        "n_img_with_gt": int(img_has_gt.sum()),
        "n_images": int(logits.shape[0]),
        "n_img_with_argmax0": int(argmax0.any(-1).sum()),
        "n_pred_argmax0": int(argmax0.sum()),
        "n_pred": int(argmax0.size),
        "sum_max_sig0": float(sig0.max(-1).sum()),
        "max_sig0": float(sig0.max()),  # aggregated as a max downstream
    }


def _step_mesh(cfg_t, device, mesh):
    """The sweep's mesh: ``mesh`` or ``auto_mesh(batch_size)``, None on one
    rank."""
    mesh = mesh if mesh is not None else auto_mesh(cfg_t.batch_size, device=device)
    if not mesh.active:
        raise RuntimeError(f"this rank is outside the {mesh.size}-rank data axis of batch {cfg_t.batch_size}")
    return mesh if mesh.size > 1 else None


@torch.no_grad()
def evaluate_destr(config, checkpoint_name: str, device: str | torch.device | None = None, mesh=None) -> dict:
    """Run the whole validation sweep for ``checkpoint_name`` (the model's
    forward in eval mode, as the trainer's eval step runs it) over ``mesh``
    (``auto_mesh`` by default); returns the metric dict."""
    device = resolve_device(device)
    cfg_t = config.train
    mesh = _step_mesh(cfg_t, device, mesh)
    canvas = int(cfg_t.image_size * 672 / 640)
    _, valid_loader = _make_loaders(config, canvas, "destr", mesh)
    model = build_destr(config.destr, device)
    model.load_state_dict(restore_for_inference(cfg_t.checkpoint_dir, checkpoint_name))

    # the forward alone, captured (evaluate.py:95-100 jits it); it holds no
    # collective, so it is captured on any mesh
    forward = CapturedEvalStep(lambda state, batch: state.model(batch["images"], batch.get("pixel_valid"))[0])
    state = TrainState(model=model, optimizer=None, rng=None)

    metric = MeanAveragePrecision(num_cls=1, num_pred=config.destr.top_k)
    coco = CocoAveragePrecision(num_cls=max(config.destr.num_cls - 1, 1))
    m_state = metric.init_state(device)
    totals: dict = {}
    for raw in valid_loader:
        batch = _eval_batch(raw, device, canvas, cfg_t.image_size)
        outputs, targets = _gathered(forward(state, batch), mesh), _gathered_targets(batch, mesh)
        m_state = metric.update(m_state, outputs, targets)
        coco.update(outputs, targets)
        d = _batch_diagnostics({k: v.cpu().numpy() for k, v in outputs.items()},
                               {k: v.cpu().numpy() for k, v in targets.items()})
        for k, v in d.items():
            if k == "max_sig0":  # the dataset's max, not a sum
                totals[k] = max(totals.get(k, 0.0), v)
            else:
                totals[k] = totals.get(k, 0.0 if isinstance(v, float) else 0) + v

    if not totals:
        raise RuntimeError(
            "empty validation split: the loader yielded zero batches "
            f"(num_valid_samples={config.data.num_valid_samples}, batch_size={cfg_t.batch_size})"
        )
    n_gt = max(totals.get("n_gt", 0), 1)
    n_img = max(totals.get("n_images", 0), 1)
    return {
        "checkpoint": checkpoint_name,
        "letterbox_eval": bool(cfg_t.letterbox_eval or cfg_t.letterbox),
        "map": metric.compute(m_state),
        "coco_map": coco.compute(),
        # localization ceiling: best-possible recall at IoU 0.5 over all predictions
        "gt_localized_frac": totals.get("n_gt_localized", 0) / n_gt,
        "mean_best_iou_per_gt": totals.get("sum_best_iou", 0.0) / n_gt,
        # mean over images with ground truth of the top-scoring prediction's best IoU
        "mean_top_pred_iou": totals.get("sum_top_iou", 0.0) / max(totals.get("n_img_with_gt", 0), 1),
        # the reference metric's selection rule: argmax(softmax) == class 0
        "img_with_argmax_fg_frac": totals.get("n_img_with_argmax0", 0) / n_img,
        "pred_argmax_fg_frac": totals.get("n_pred_argmax0", 0) / max(totals.get("n_pred", 0), 1),
        # score calibration
        "mean_image_max_score": totals.get("sum_max_sig0", 0.0) / n_img,
        "max_score": totals.get("max_sig0", 0.0),
        "n_gt": int(totals.get("n_gt", 0)),
        "n_images": int(totals.get("n_images", 0)),
    }


@torch.no_grad()
def evaluate_ssd(config, checkpoint_name: str, device: str | torch.device | None = None, mesh=None) -> dict:
    """The SSD driver's validation sweep for ``checkpoint_name``, standalone
    (over ``mesh``, as :func:`evaluate_destr`): the reference 11-point mAP
    over ``num_cls`` classes, the mean val loss, and the localization
    ceiling (for each ground truth the best IoU over all decoded default
    boxes, which no confidence or NMS can exceed)."""
    device = resolve_device(device)
    cfg_t = config.train
    mesh = _step_mesh(cfg_t, device, mesh)
    _, valid_loader = _make_loaders(config, int(config.ssd.image_size * 1.28), "ssd", mesh)  # the trainer's canvas
    model = build_ssd(config.ssd, device)
    model.load_state_dict(restore_for_inference(cfg_t.checkpoint_dir, checkpoint_name))
    state = TrainState(model=model, optimizer=None, rng=None)  # the eval step reads the model only
    eval_step = CapturedEvalStep(make_ssd_eval_step(cfg_t, config.ssd, mesh), mesh)

    metric = MeanAveragePrecision(num_cls=config.ssd.num_cls)
    m_state = metric.init_state(device)
    losses, totals = [], {"n_gt": 0, "sum_best_iou": 0.0, "n_gt_localized": 0, "n_images": 0}
    for raw in valid_loader:
        b = _to_device(raw, device)
        batch = ssd_eval_transform(b["images"], b["boxes"], b["labels"], b["valid"], out_size=config.ssd.image_size)
        _, batch_losses, detections = eval_step(state, batch)
        losses.append(batch_losses["loss"].clone())  # the captured step's output is overwritten by the next
        targets = _gathered_targets(batch, mesh)
        gt_xyxy = cxcyhw_to_xyxy(targets["boxes"])
        m_state = metric.update(m_state, detections, {**targets, "boxes": gt_xyxy})
        best = pairwise_iou(cxcyhw_to_xyxy(detections["pred_boxes"]), gt_xyxy).amax(dim=1)  # (B, T)
        best, gt_valid = best.cpu().numpy(), targets["valid"].cpu().numpy()
        totals["n_gt"] += int(gt_valid.sum())
        totals["sum_best_iou"] += float(best[gt_valid].sum())
        totals["n_gt_localized"] += int((best[gt_valid] >= 0.5).sum())
        totals["n_images"] += int(gt_valid.shape[0])
    if not losses:
        raise RuntimeError(
            "empty validation split: the loader yielded zero batches "
            f"(num_valid_samples={config.data.num_valid_samples}, batch_size={cfg_t.batch_size})"
        )
    n_gt = max(totals["n_gt"], 1)
    return {
        "checkpoint": checkpoint_name,
        "map": metric.compute(m_state),
        "val_loss": float(torch.stack(losses).float().mean()),
        "gt_localized_frac": totals["n_gt_localized"] / n_gt,
        "mean_best_iou_per_gt": totals["sum_best_iou"] / n_gt,
        "n_gt": totals["n_gt"],
        "n_images": totals["n_images"],
    }


def _with_model_flag(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--model", choices=("destr", "ssd"), default="destr",
                        help="the checkpoint's model; the other flags are its trainer's")
    return parser


def main(argv=None) -> dict:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    # pre-parse: the model decides the flag set (argparse reads --model X and
    # --model=X, and exits 2 on a missing or unknown value)
    kind = _with_model_flag(argparse.ArgumentParser(add_help=False)).parse_known_args(argv)[0].model
    args = _with_model_flag(get_parser(kind)).parse_args(argv)
    config = config_from_args(args, kind)
    evaluate = evaluate_ssd if kind == "ssd" else evaluate_destr
    with launched(args.device) as device:
        result = evaluate(config, args.resume_from, device=device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in result.items()}),
                  flush=True)
    return result


if __name__ == "__main__":
    main()
