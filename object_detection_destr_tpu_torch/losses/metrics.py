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

As in JAX, a batch's update is one device program over every class at once:
one softmax (sigmoid) and one stable sort (top-k) over (B, C, N), cut to the
ranks that count before the gather, one IoU over (B, C, R, T), and one
launch of the greedy walk over the B x C problems
(``ops/cuda/greedy_match.py``: the CUDA kernel on the GPU, its plain version
on the CPU). The 11-point state (``tp``, ``fp``, ``num_gts``) stays on the
outputs' device and its update copies nothing to the host; COCO's update
copies the batch's records to the host once (metrics.py:209-211). Only
``compute`` runs on the host.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..geometry.boxes import cxcyhw_to_xyxy, pairwise_iou
from ..ops.cuda.greedy_match import greedy_match
from ..ops.topk import stable_topk

__all__ = ["CocoAveragePrecision", "MeanAveragePrecision"]


def _inputs(outputs: Mapping, targets: Mapping, num_cls: int):
    """(logits (B, N, C') float32, predicted xyxy (B, N, 4), targets' xyxy
    (B, T, 4), gt_valid (B, C, T): the valid targets of each of the first
    ``num_cls`` classes), all on the outputs' device."""
    logits = torch.as_tensor(outputs["pred_class"]).float()
    dev = logits.device
    pred_xyxy = cxcyhw_to_xyxy(torch.as_tensor(outputs["pred_boxes"]).float())
    gt_xyxy = torch.as_tensor(targets["boxes"], device=dev).float()
    labels = torch.as_tensor(targets["labels"], device=dev)
    valid = torch.as_tensor(targets["valid"], device=dev)
    classes = torch.arange(num_cls, device=dev)
    gt_valid = valid[:, None, :] & (labels[:, None, :] == classes[None, :, None])
    return logits, pred_xyxy, gt_xyxy, gt_valid


def _host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """The tensors on the host in one copy, each in its own shape: float32
    ones as they are, integer counts (below 2^24, exact in float32) back as
    int64."""
    tensors = [torch.as_tensor(x) for x in tensors]
    flat = torch.cat([x.reshape(-1).float() for x in tensors]).cpu().numpy()
    out, at = [], 0
    for x in tensors:
        n = x.numel()
        part = flat[at:at + n].reshape(tuple(x.shape))
        out.append(part if x.dtype == torch.float32 else part.astype(np.int64))
        at += n
    return out


def _ranked_iou(pred_xyxy, order, gt_xyxy, gt_valid):
    """(B, C, R, T) IoU of the ranked predictions (``order`` (B, C, R)
    indices into N) against every target, -1 where the target is not a
    valid one of the class."""
    b, c, r = order.shape
    boxes = torch.gather(pred_xyxy[:, None].expand(b, c, -1, 4), 2, order[..., None].expand(b, c, r, 4))
    return torch.where(gt_valid[:, :, None, :], pairwise_iou(boxes, gt_xyxy[:, None]), -1.0)


class MeanAveragePrecision:
    """The 11-point mAP accumulator (state in, state out), as in JAX::

        metric = MeanAveragePrecision(num_cls=1)
        state = metric.init_state(device)
        for batch in loader:
            state = metric.update(state, outputs, targets)  # on the device
        ap = metric.compute(state)  # on the host

    The state is tensors on the outputs' device: tp, fp (num_cls, num_pred)
    float32 by rank and num_gts (num_cls,) int64.
    """

    def __init__(self, num_cls: int = 1, threshold: float = 0.5, num_pred: int = 300):
        self.num_cls = num_cls
        self.threshold = threshold
        self.num_pred = num_pred

    def init_state(self, device: Optional[torch.device | str] = None) -> dict:
        z = torch.zeros((self.num_cls, self.num_pred), dtype=torch.float32, device=device)
        return {"tp": z, "fp": z.clone(), "num_gts": torch.zeros((self.num_cls,), dtype=torch.int64, device=device)}

    @torch.no_grad()
    def update(self, state: dict, outputs: Mapping, targets: Mapping) -> dict:
        """The state after one batch; nothing is copied to the host."""
        logits, pred_xyxy, gt_xyxy, gt_valid = _inputs(outputs, targets, self.num_cls)
        b, n = logits.shape[:2]
        c, dev = self.num_cls, logits.device
        probs = torch.softmax(logits, dim=-1)
        classes = torch.arange(c, device=dev)
        pred_is_cls = probs.argmax(-1)[:, None, :] == classes[None, :, None]  # (B, C, N)
        sort_key = torch.where(pred_is_cls, probs[..., :c].transpose(1, 2), -torch.inf)
        # only the top n_ranks ever count: cut the order before the gather and
        # the IoU (metrics.py:66-72)
        n_ranks = min(n, self.num_pred)
        order = torch.sort(-sort_key, dim=-1, stable=True).indices[..., :n_ranks]  # (B, C, R)
        iou = _ranked_iou(pred_xyxy, order, gt_xyxy, gt_valid)
        n_gt = gt_valid.sum(-1)  # (B, C)
        # the reference skips images without ground truth of the class
        n_use = torch.where(n_gt > 0, pred_is_cls.sum(-1), 0)
        hit = greedy_match(iou.reshape(b * c, n_ranks, -1), n_use.reshape(-1), [self.threshold],
                           skip_matched=False).reshape(b, c, n_ranks)
        used = torch.arange(n_ranks, device=dev) < n_use[..., None]  # (B, C, R)
        tp, fp = state["tp"].to(dev).clone(), state["fp"].to(dev).clone()
        tp[:, :n_ranks] += (hit & used).sum(0, dtype=torch.float32)
        fp[:, :n_ranks] += (~hit & used).sum(0, dtype=torch.float32)
        return {"tp": tp, "fp": fp, "num_gts": state["num_gts"].to(dev) + n_gt.sum(0)}

    def compute(self, state: dict) -> float:
        """11-point interpolated AP, averaged over classes (metrics.py:152-174);
        the state comes to the host in one copy."""
        tp, fp, num_gts = _host(state["tp"], state["fp"], state["num_gts"])
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
        each IoU threshold), copied to the host in one copy
        (metrics.py:200-211)."""
        records = _coco_batch_records(outputs, targets, num_cls=self.num_cls, max_dets=self.max_dets,
                                      iou_thresholds=self.IOU_THRESHOLDS)
        scores, tps, n_gt = _host(*records)
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
                        iou_thresholds) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image, per-class top-``max_dets`` detection records for COCO AP
    (metrics.py:245-291), on the outputs' device: scores (B, C, K) float32,
    -1 in padded slots; tp (B, C, K, n_iou) float32 hit flags; n_gt (B, C)
    int64 valid ground truths of the class in each image."""
    logits, pred_xyxy, gt_xyxy, gt_valid = _inputs(outputs, targets, num_cls)
    b, n = logits.shape[:2]
    dev = logits.device
    probs = torch.sigmoid(logits[..., :num_cls]).transpose(1, 2)  # (B, C, N)
    k = min(max_dets, n)
    top_s, top_i = stable_topk(probs, k)  # lax.top_k's tie order
    iou = _ranked_iou(pred_xyxy, top_i, gt_xyxy, gt_valid)  # (B, C, K, T)
    n_use = torch.full((b * num_cls,), k, dtype=torch.int32, device=dev)
    hits = greedy_match(iou.reshape(b * num_cls, k, -1), n_use, iou_thresholds, skip_matched=True)
    scores = torch.full((b, num_cls, max_dets), -1.0, dtype=torch.float32, device=dev)
    scores[..., :k] = top_s
    tps = torch.zeros((b, num_cls, max_dets, len(iou_thresholds)), dtype=torch.float32, device=dev)
    tps[:, :, :k] = hits.reshape(b, num_cls, k, -1)
    return scores, tps, gt_valid.sum(-1)
