"""Detection evaluation: (mean) average precision (the port's copy of
``analytics_zoo_tpu/models/image/objectdetection/evaluation.py``).

Reference: objectdetection/common/evaluation/MeanAveragePrecision.scala and
PascalVocEvaluator.scala — VOC-style AP with both the VOC2007 11-point
interpolation and the integral (area-under-PR) variant, matched at a
configurable IoU threshold, greedy one-gt-per-detection matching in score
order, optional ``use_difficult`` exclusion.
"""

from __future__ import annotations

import numpy as np


def _voc_ap(recall, precision, use_07_metric=False):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return ap
    # integral AP: envelope then sum of rectangle areas
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_1_to_many(box, boxes):
    lo = np.maximum(box[0:2], boxes[:, 0:2])
    hi = np.minimum(box[2:4], boxes[:, 2:4])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
    union = (np.prod(box[2:4] - box[0:2])
             + np.prod(boxes[:, 2:4] - boxes[:, 0:2], axis=1) - inter)
    return np.where(union > 0, inter / union, 0.0)


def average_precision(detections, ground_truths, class_id: int,
                      iou_threshold=0.5, use_07_metric=False) -> float:
    """AP for one class.

    Args:
      detections: list per image of dicts (boxes, scores, classes).
      ground_truths: list per image of dicts (boxes, classes, optional
        difficult bool array).
    """
    # flatten detections of this class with image ids
    rows = []
    for img_id, det in enumerate(detections):
        sel = det["classes"] == class_id
        for box, score in zip(det["boxes"][sel], det["scores"][sel]):
            rows.append((score, img_id, box))
    rows.sort(key=lambda r: -r[0])

    gts, n_positive = {}, 0
    for img_id, gt in enumerate(ground_truths):
        sel = np.asarray(gt["classes"]) == class_id
        boxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)[sel]
        difficult = np.asarray(
            gt.get("difficult", np.zeros(len(sel), bool)))[sel]
        gts[img_id] = (boxes, difficult, np.zeros(len(boxes), bool))
        n_positive += int((~difficult).sum())
    if n_positive == 0:
        # VOC convention: a class with no gt instances is excluded from mAP
        return float("nan")

    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for i, (score, img_id, box) in enumerate(rows):
        boxes, difficult, used = gts[img_id]
        if len(boxes) == 0:
            fp[i] = 1
            continue
        ious = _iou_1_to_many(np.asarray(box, np.float32), boxes)
        j = int(np.argmax(ious))
        if ious[j] >= iou_threshold and not used[j]:
            if difficult[j]:
                continue  # neither tp nor fp (VOC convention)
            used[j] = True
            tp[i] = 1
        else:
            fp[i] = 1

    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(fp)
    recall = cum_tp / n_positive
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-10)
    return _voc_ap(recall, precision, use_07_metric)


def mean_average_precision(detections, ground_truths, n_classes: int,
                           iou_threshold=0.5, use_07_metric=False) -> float:
    """mAP over classes (reference MeanAveragePrecision.scala)."""
    aps = [
        average_precision(detections, ground_truths, c, iou_threshold,
                          use_07_metric)
        for c in range(n_classes)
    ]
    aps = [a for a in aps if not np.isnan(a)]  # skip classes with no gt
    return float(np.mean(aps)) if aps else 0.0


class PascalVocEvaluator:
    """Reference PascalVocEvaluator.scala: per-class AP table + mAP with the
    VOC2007 11-point metric by default."""

    def __init__(self, class_names, iou_threshold=0.5, use_07_metric=True):
        self.class_names = list(class_names)
        self.iou_threshold = iou_threshold
        self.use_07_metric = use_07_metric

    def evaluate(self, detections, ground_truths):
        per_class = {
            name: average_precision(
                detections, ground_truths, c, self.iou_threshold,
                self.use_07_metric)
            for c, name in enumerate(self.class_names)
        }
        present = [a for a in per_class.values() if not np.isnan(a)]
        return {
            "AP": per_class,
            "mAP": float(np.mean(present)) if present else 0.0,
        }
