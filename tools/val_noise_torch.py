"""Quantify the validation mAP's noise for one fixed checkpoint of the
PyTorch port's trainer: the port's counterpart of ``tools/val_noise.py``.

A production curve whose val mAP swings between adjacent epochs (0.27-0.53
on the JAX run of record's 256-image synthetic split) has two candidate
explanations: the metric and its protocol (loader order, batch
composition, the sampling noise of a small split), or the parameters really
moving that much an epoch. For one checkpoint this tool:

1. runs the whole validation sweep under ``--orders N`` valid-loader seeds
   (only the loader's shuffle, ``DetectionLoader.seed``, which the loader
   reads as ``default_rng((seed, epoch))``; the split itself keeps its
   dataset seed, ``seed + 10_000``) and checks that the accumulated
   ``MeanAveragePrecision`` state (``tp``, ``fp``, ``num_gts``) is
   identical across orders: the metric sums per-image rank histograms, so
   the order cannot matter, and this checks it end to end through the
   loader, the eval transform and the model;
2. collects per-image records from the first sweep's outputs (the
   reference metric's rows through the metric's own ``update`` on B=1
   slices, COCO's through ``losses/metrics.py::_coco_batch_records``, no
   second forward), checks that they sum back to the sweep's mAP and COCO
   AP exactly, and bootstraps the image set ``--bootstrap K`` times
   (``default_rng(0)``).

The bootstrap's spread is the metric noise of the split's size; what the
epoch-to-epoch curve shows beyond it is the model moving.

The sweep is the trainer's (``train/driver.py::_make_loaders``,
``_val_sweep``, ``_eval_batch`` and ``train/steps.py::make_destr_eval_step``):
on the GPU it launches flash-attention kernel #1 18 times and the matcher
#9 once a batch at 6+6 blocks. It runs on the GPU unless ``--device cpu``
is given, on one device. Usage (the trainer's flags, plus the two knobs)::

    python tools/val_noise_torch.py --resume_from prod --checkpoint_dir ckpt \\
        --dataset synthetic --synthetic_size 672 --num_valid_samples 256 \\
        --image_size 640 --batch_size 16 --compute_dtype bfloat16 --top_k 300 \\
        --num_encoder_blocks 6 --num_decoder_blocks 6 --bootstrap 1000 --orders 3

Prints one JSON line last, with the JAX tool's keys and the device's name.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from object_detection_destr_tpu_torch.config import resolve_device  # noqa: E402
from object_detection_destr_tpu_torch.losses.metrics import (  # noqa: E402
    CocoAveragePrecision,
    MeanAveragePrecision,
    _coco_batch_records,
)
from object_detection_destr_tpu_torch.models.destr.model import build_destr  # noqa: E402
from object_detection_destr_tpu_torch.train.arg_parser import config_from_args, get_parser  # noqa: E402
from object_detection_destr_tpu_torch.train.checkpoint import restore_for_inference  # noqa: E402
from object_detection_destr_tpu_torch.train.driver import _make_loaders, _val_sweep  # noqa: E402
from object_detection_destr_tpu_torch.train.state import TrainState  # noqa: E402
from object_detection_destr_tpu_torch.train.steps import make_destr_eval_step  # noqa: E402

ROW_KEYS = ("tp", "fp", "n_gt", "coco_scores", "coco_tp", "coco_ngt")


def image_rows(rows: dict, metric: MeanAveragePrecision, coco: CocoAveragePrecision, outputs: dict,
               targets: dict) -> None:
    """Append one batch's per-image records to ``rows``: the reference
    metric's tp / fp rank rows and ground-truth count of each image (the
    metric's own ``update`` on a batch of one), and its COCO records
    (scores (C, K), hits (C, K, n_iou), ground truths (C,))."""
    for i in range(outputs["pred_class"].shape[0]):
        one = metric.update(metric.init_state(),
                            {k: outputs[k][i:i + 1] for k in ("pred_class", "pred_boxes")},
                            {k: v[i:i + 1] for k, v in targets.items()})
        rows["tp"].append(one["tp"][0])
        rows["fp"].append(one["fp"][0])
        rows["n_gt"].append(int(one["num_gts"][0]))
    scores, tp, n_gt = _coco_batch_records(outputs, targets, num_cls=coco.num_cls, max_dets=coco.max_dets,
                                           iou_thresholds=coco.IOU_THRESHOLDS)
    rows["coco_scores"].append(scores)
    rows["coco_tp"].append(tp)
    rows["coco_ngt"].append(n_gt)


def sweep(config, state: TrainState, device: torch.device, loader_seed: int, collect: bool):
    """One whole validation sweep with the valid loader's order reseeded:
    (the final metric state, the COCO metric, the per-image rows or None,
    the metric)."""
    cfg_t = config.train
    canvas = int(cfg_t.image_size * 672 / 640)  # the trainer's canvas
    _, valid_loader = _make_loaders(config, canvas, "destr")
    valid_loader.seed = loader_seed  # the order only; the split keeps its dataset seed
    metric = MeanAveragePrecision(num_cls=1, num_pred=config.destr.top_k)
    coco = CocoAveragePrecision(num_cls=max(config.destr.num_cls - 1, 1))
    rows = {k: [] for k in ROW_KEYS} if collect else None
    final = {"state": metric.init_state()}

    def on_batch(outputs, targets, metric_state):
        final["state"] = metric_state
        if rows is not None:
            image_rows(rows, metric, coco, outputs, targets)

    _val_sweep(state, valid_loader, make_destr_eval_step(cfg_t), metric, coco, device, canvas, cfg_t.image_size,
               on_batch=on_batch)
    return final["state"], coco, rows, metric


def ref_ap_from_rows(tp_rows, fp_rows, n_gts, metric) -> float:
    """The reference mAP of a set of images from their rows."""
    state = {"tp": np.sum(tp_rows, axis=0, keepdims=True), "fp": np.sum(fp_rows, axis=0, keepdims=True),
             "num_gts": np.asarray([int(np.sum(n_gts))])}
    return metric.compute(state)


def coco_ap_from_records(scores, tp, ngt, template: CocoAveragePrecision) -> float:
    """COCO AP of a set of images from their records."""
    c = CocoAveragePrecision(num_cls=template.num_cls, max_dets_per_image=template.max_dets)
    c._scores = [scores]
    c._tp = [tp]
    c._num_gts = ngt.sum(axis=0).astype(np.int64)
    return c.compute()


def stacked(rows: dict) -> dict:
    """The per-image rows as arrays, one leading entry an image."""
    return {"tp": np.stack(rows["tp"]), "fp": np.stack(rows["fp"]), "n_gt": np.asarray(rows["n_gt"]),
            **{k: np.concatenate(rows[k], axis=0) for k in ("coco_scores", "coco_tp", "coco_ngt")}}


def bootstrap(images: dict, k: int, metric, coco, ref_ap=ref_ap_from_rows, coco_ap=coco_ap_from_records):
    """(mAPs, COCO APs) of ``k`` resamples of the images with replacement,
    drawn from ``default_rng(0)``; ``ref_ap`` / ``coco_ap`` score a resample
    (the JAX tool's functions can be given in their place)."""
    n = images["tp"].shape[0]
    rng = np.random.default_rng(0)
    maps, cocos = [], []
    for _ in range(k):
        idx = rng.integers(0, n, size=n)
        maps.append(ref_ap(images["tp"][idx], images["fp"][idx], images["n_gt"][idx], metric))
        cocos.append(coco_ap(images["coco_scores"][idx], images["coco_tp"][idx], images["coco_ngt"][idx], coco))
    return np.asarray(maps), np.asarray(cocos)


def _stats(a: np.ndarray) -> dict:
    return {"mean": float(a.mean()), "std": float(a.std()), "p2.5": float(np.percentile(a, 2.5)),
            "p97.5": float(np.percentile(a, 97.5))}


def main(argv=None) -> dict:
    parser = get_parser("destr")
    parser.add_argument("--bootstrap", type=int, default=1000)
    parser.add_argument("--orders", type=int, default=3)
    args = parser.parse_args(argv)
    config = config_from_args(args, "destr")
    device = resolve_device(args.device)

    model = build_destr(config.destr, device)
    model.load_state_dict(restore_for_inference(config.train.checkpoint_dir, args.resume_from))
    state = TrainState(model=model, optimizer=None, rng=None)  # the eval step reads the model only

    # order invariance: the whole sweep under several valid-loader seeds
    states, rows, metric, coco0 = [], None, None, None
    for k in range(max(args.orders, 1)):
        st, coco, pi, metric = sweep(config, state, device, loader_seed=1000 + 17 * k, collect=k == 0)
        states.append(st)
        if k == 0:
            rows, coco0 = pi, coco
    order_same = all(np.array_equal(s[key], states[0][key]) for s in states[1:] for key in ("tp", "fp", "num_gts"))
    point_map = metric.compute(states[0])
    point_coco = coco0.compute()

    # the per-image records must give back the sweep's metrics exactly
    images = stacked(rows)
    rows_exact = abs(ref_ap_from_rows(images["tp"], images["fp"], images["n_gt"], metric) - point_map) < 1e-9
    coco_exact = abs(coco_ap_from_records(images["coco_scores"], images["coco_tp"], images["coco_ngt"], coco0)
                     - point_coco) < 1e-9

    maps, cocos = bootstrap(images, args.bootstrap, metric, coco0)
    result = {
        "checkpoint": args.resume_from,
        "n_images": int(images["tp"].shape[0]),
        "orders_tested": int(args.orders),
        "order_invariant": bool(order_same),
        "per_image_rows_reproduce_sweep": bool(rows_exact and coco_exact),
        "map_point": round(point_map, 5),
        "coco_point": round(point_coco, 5),
        "bootstrap_K": int(args.bootstrap),
        "map_bootstrap": {k: round(v, 5) for k, v in _stats(maps).items()} if args.bootstrap else None,
        "coco_bootstrap": {k: round(v, 5) for k, v in _stats(cocos).items()} if args.bootstrap else None,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
