"""Mean-average-precision metrics (port of
``object_detection_destr_tpu/losses/metrics.py``).

``MeanAveragePrecision`` (l.38-174) is the reference's 11-point metric:

* per image, the predictions whose argmax-softmax class is the metric class
  are selected and sorted by that class's probability (a stable descending
  sort, cut to the top ``num_pred`` ranks);
* greedy first-match-wins at IoU >= threshold against the best-IoU valid
  ground truth, true and false positives accumulated by per-image rank;
* images with no ground truth of the class are skipped;
* 11-point interpolated AP, averaged over classes.

``CocoAveragePrecision`` (l.177-291) scores detections by sigmoid, keeps the
top 100 of each class per image (``lax.top_k``'s tie order), matches greedily
in score order at each of the IoU thresholds 0.5:0.95:0.05 and interpolates
101 recall points over the dataset; padded slots carry score -1.

The selection, sort, gather and IoU run as batched tensor ops on the
outputs' device. The greedy matches are sequential by definition: each batch
copies its (B, ranks, T) IoU block to the host once, and numpy walks the
ranks with every image (and every IoU threshold) at once, stopping at the
last rank any image selected.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..geometry.boxes import cxcyhw_to_xyxy, pairwise_iou
from ..ops.topk import stable_topk

__all__ = ["CocoAveragePrecision", "MeanAveragePrecision"]


def _greedy_ranks(iou: np.ndarray, n_use: np.ndarray, threshold: np.ndarray, skip_matched: bool) -> np.ndarray:
    """Greedy first-match-wins over the ranks of a batch, every image and
    every threshold at once.

    Args:
        iou: (B, R, T) float32, -1 where the target is not a valid one.
        n_use: (B,) ranks that count in each image (later ones miss).
        threshold: (J,) float32 IoU thresholds, each matched on its own.
        skip_matched: False is the 11-point metric's rule: the best-IoU
            valid target, a miss if it is taken already (metrics.py:83-92);
            True is COCO's: the best-IoU target not yet taken (l.265-275).

    Returns:
        (B, R, J) bool hits.
    """
    b, r, t = iou.shape
    j = threshold.shape[0]
    hits = np.zeros((b, r, j), bool)
    matched = np.zeros((b, j, t), bool)
    rows, cols = np.arange(b)[:, None], np.arange(j)[None, :]
    for i in range(min(int(n_use.max(initial=0)), r)):
        row = np.broadcast_to(iou[:, None, i, :], (b, j, t))  # (B, J, T)
        if skip_matched:
            row = np.where(matched, np.float32(-1.0), row)
        best = row.argmax(-1)  # (B, J)
        best_iou = np.take_along_axis(row, best[..., None], -1)[..., 0]
        hit = (best_iou >= threshold[None, :]) & ~matched[rows, cols, best] & (i < n_use)[:, None]
        matched[rows, cols, best] |= hit
        hits[:, i] = hit
    return hits


class MeanAveragePrecision:
    """The 11-point mAP accumulator (state in, state out), as in JAX::

        metric = MeanAveragePrecision(num_cls=1)
        state = metric.init_state()
        for batch in loader:
            state = metric.update(state, outputs, targets)
        ap = metric.compute(state)

    The state is host numpy: tp, fp (num_cls, num_pred) float32 by rank and
    num_gts (num_cls,) int64.
    """

    def __init__(self, num_cls: int = 1, threshold: float = 0.5, num_pred: int = 300):
        self.num_cls = num_cls
        self.threshold = threshold
        self.num_pred = num_pred

    def init_state(self) -> dict:
        z = np.zeros((self.num_cls, self.num_pred), np.float32)
        return {"tp": z, "fp": z.copy(), "num_gts": np.zeros((self.num_cls,), np.int64)}

    @torch.no_grad()
    def update(self, state: dict, outputs: Mapping, targets: Mapping) -> dict:
        logits = torch.as_tensor(outputs["pred_class"]).float()  # (B, N, C)
        pred_xyxy = cxcyhw_to_xyxy(torch.as_tensor(outputs["pred_boxes"]).float())
        gt_xyxy = torch.as_tensor(targets["boxes"], device=logits.device).float()  # (B, T, 4)
        labels = torch.as_tensor(targets["labels"], device=logits.device)
        valid = torch.as_tensor(targets["valid"], device=logits.device)
        probs = torch.softmax(logits, dim=-1)
        top = probs.argmax(-1)  # (B, N)
        n_ranks = min(logits.shape[1], self.num_pred)
        tp, fp, num_gts = state["tp"].copy(), state["fp"].copy(), state["num_gts"].copy()
        thr = np.asarray([self.threshold], np.float32)
        for cls in range(self.num_cls):
            gt_valid = valid & (labels == cls)  # (B, T)
            pred_is_cls = top == cls
            sort_key = torch.where(pred_is_cls, probs[..., cls], -torch.inf)
            order = torch.sort(-sort_key, dim=-1, stable=True).indices[:, :n_ranks]
            boxes_sorted = torch.gather(pred_xyxy, 1, order[..., None].expand(-1, -1, 4))
            iou = torch.where(gt_valid[:, None, :], pairwise_iou(boxes_sorted, gt_xyxy), -1.0)
            n_gt = gt_valid.sum(-1)
            active = n_gt > 0  # the reference skips images without ground truth
            n_use = torch.where(active, pred_is_cls.sum(-1), 0)
            iou_h, n_use_h, n_gt_h = (x.cpu().numpy() for x in (iou, n_use, n_gt))
            hit = _greedy_ranks(iou_h, n_use_h, thr, skip_matched=False)[..., 0]  # (B, R)
            used = np.arange(n_ranks)[None, :] < n_use_h[:, None]
            tp[cls, :n_ranks] += (hit & used).sum(0, dtype=np.float32)
            fp[cls, :n_ranks] += (~hit & used).sum(0, dtype=np.float32)
            num_gts[cls] += int(n_gt_h[n_gt_h > 0].sum())
        return {"tp": tp, "fp": fp, "num_gts": num_gts}

    def compute(self, state: dict) -> float:
        """11-point interpolated AP, averaged over classes (metrics.py:152-174)."""
        tp, fp, num_gts = (np.asarray(state[k]) for k in ("tp", "fp", "num_gts"))
        aps = []
        for cls in range(self.num_cls):
            if num_gts[cls] == 0:
                aps.append(0.0)
                continue
            cum_tp = np.cumsum(tp[cls])
            cum_fp = np.cumsum(fp[cls])
            recall = cum_tp / num_gts[cls]
            with np.errstate(invalid="ignore"):
                precision = np.where(
                    cum_tp + cum_fp > 0, cum_tp / np.maximum(cum_tp + cum_fp, 1e-12), 0.0
                )
            ap = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                mask = recall >= t
                ap += (np.max(precision[mask]) if mask.any() else 0.0) / 11.0
            aps.append(float(ap))
        return float(np.mean(aps))


class CocoAveragePrecision:
    """COCO-style AP: score-ordered across the dataset, 101-point
    interpolation, averaged over IoU thresholds 0.5:0.95:0.05 (no crowd
    regions, one area range, one max-detections value)."""

    IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2).tolist())

    def __init__(self, num_cls: int = 1, max_dets_per_image: int = 100):
        self.num_cls = num_cls
        self.max_dets = max_dets_per_image
        self.reset()

    def reset(self) -> None:
        self._scores: list[np.ndarray] = []
        self._tp: list[np.ndarray] = []  # (B, C, K, n_iou)
        self._num_gts = np.zeros((self.num_cls,), np.int64)

    def update(self, outputs: Mapping, targets: Mapping) -> None:
        """Per image and class, the top ``max_dets`` records: (score, hit at
        each IoU threshold) (metrics.py:200-211)."""
        scores, tps, n_gt = _coco_batch_records(outputs, targets, num_cls=self.num_cls, max_dets=self.max_dets,
                                                iou_thresholds=self.IOU_THRESHOLDS)
        self._scores.append(scores)
        self._tp.append(tps)
        self._num_gts += n_gt.sum(axis=0)

    def compute(self) -> float:
        if not self._scores:
            return 0.0
        scores = np.concatenate(self._scores, axis=0)  # (B*, C, K)
        tps = np.concatenate(self._tp, axis=0)  # (B*, C, K, n_iou)
        recall_pts = np.linspace(0.0, 1.0, 101)
        aps = []
        for cls in range(self.num_cls):
            if self._num_gts[cls] == 0:
                continue
            s = scores[:, cls].reshape(-1)
            t = tps[:, cls].reshape(-1, len(self.IOU_THRESHOLDS))
            keep = s > -1.0  # padded slots carry score -1 (NaN also fails)
            s, t = s[keep], t[keep]
            if s.size == 0:  # no detections survived (e.g. a NaN epoch)
                aps.extend([0.0] * len(self.IOU_THRESHOLDS))
                continue
            order = np.argsort(-s, kind="stable")
            t = t[order]
            for j in range(len(self.IOU_THRESHOLDS)):
                cum_tp = np.cumsum(t[:, j])
                cum_fp = np.cumsum(1.0 - t[:, j])
                recall = cum_tp / self._num_gts[cls]
                precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
                precision = np.maximum.accumulate(precision[::-1])[::-1]  # monotone envelope
                idx = np.searchsorted(recall, recall_pts, side="left")
                pr = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
                aps.append(pr.mean())
        return float(np.mean(aps)) if aps else 0.0


@torch.no_grad()
def _coco_batch_records(outputs: Mapping, targets: Mapping, *, num_cls: int, max_dets: int,
                        iou_thresholds) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-image, per-class top-``max_dets`` detection records for COCO AP
    (metrics.py:245-291): host numpy (scores (B, C, K) float32, -1 in padded
    slots; tp (B, C, K, n_iou) float32 hit flags; n_gt (B, C) int64 valid
    ground truths of the class in each image)."""
    logits = torch.as_tensor(outputs["pred_class"]).float()
    pred_xyxy = cxcyhw_to_xyxy(torch.as_tensor(outputs["pred_boxes"]).float())
    gt_xyxy = torch.as_tensor(targets["boxes"], device=logits.device).float()
    labels = torch.as_tensor(targets["labels"], device=logits.device).int()
    valid = torch.as_tensor(targets["valid"], device=logits.device)
    probs = torch.sigmoid(logits)
    b, n = probs.shape[:2]
    k = min(max_dets, n)
    thresholds = np.asarray(iou_thresholds, np.float32)
    scores = np.full((b, num_cls, max_dets), -1.0, np.float32)
    tps = np.zeros((b, num_cls, max_dets, len(thresholds)), np.float32)
    n_gt = np.zeros((b, num_cls), np.int64)
    for cls in range(num_cls):
        top_s, top_i = stable_topk(probs[..., cls], k)  # lax.top_k's tie order
        top_boxes = torch.gather(pred_xyxy, 1, top_i[..., None].expand(-1, -1, 4))
        gvalid = valid & (labels == cls)
        iou = torch.where(gvalid[:, None, :], pairwise_iou(top_boxes, gt_xyxy), -1.0)
        hits = _greedy_ranks(iou.cpu().numpy(), np.full((b,), k), thresholds, skip_matched=True)
        scores[:, cls, :k] = top_s.cpu().numpy()
        tps[:, cls, :k] = hits
        n_gt[:, cls] = gvalid.sum(-1).cpu().numpy()
    return scores, tps, n_gt
