"""Detection postprocess: decode + per-class NMS + top-k (counterpart of
``analytics_zoo_tpu/models/image/objectdetection/postprocess.py``).

Reference: the SSD DetectionOutput / NMS postprocess under
objectdetection/common (Scala, per-image mutable loops on CPU).

Box decoding and the score softmax are batched torch on the device the
raw output lies on; NMS + top-k run on the host in numpy over the small
decoded set — the reference's division (device math, host postprocess),
and the answer to NMS's data-dependent shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss import (
    decode_boxes,
)


def decode_predictions(y_pred, priors_center, variances=(0.1, 0.2)):
    """(B, P, 4+C+1) raw output -> (boxes (B, P, 4) corner, scores
    (B, P, C+1) softmax), torch on ``y_pred``'s device."""
    loc = y_pred[..., :4]
    logits = y_pred[..., 4:]
    boxes = decode_boxes(loc, priors_center, variances)
    scores = torch.softmax(logits, dim=-1)
    return boxes, scores


def nms_numpy(boxes: np.ndarray, scores: np.ndarray,
              iou_threshold: float = 0.45, top_k: int = 200) -> np.ndarray:
    """Greedy NMS; returns kept indices (host-side)."""
    order = np.argsort(-scores)[:top_k * 4]
    keep = []
    areas = np.prod(np.clip(boxes[:, 2:4] - boxes[:, 0:2], 0, None), axis=1)
    while order.size and len(keep) < top_k:
        i = order[0]
        keep.append(i)
        lo = np.maximum(boxes[i, 0:2], boxes[order[1:], 0:2])
        hi = np.minimum(boxes[i, 2:4], boxes[order[1:], 2:4])
        inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
        union = areas[i] + areas[order[1:]] - inter
        iou = np.where(union > 0, inter / union, 0.0)
        order = order[1:][iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def detect(y_pred, priors_center, conf_threshold=0.01, iou_threshold=0.45,
           top_k=200, variances=(0.1, 0.2)):
    """Full postprocess for a batch.

    ``y_pred`` is a tensor (decoded on its device) or an array (decoded on
    the CPU).  Returns a list (length B) of dicts with ``boxes`` (N, 4)
    corner [0,1], ``scores`` (N,), ``classes`` (N,) zero-based
    (background removed) — the reference DetectionOutput format.
    """
    if not torch.is_tensor(y_pred):
        y_pred = torch.from_numpy(np.asarray(y_pred, np.float32))
    priors = torch.as_tensor(np.asarray(priors_center, np.float32),
                             device=y_pred.device)
    boxes, scores = decode_predictions(y_pred.float(), priors, variances)
    return nms_decoded(boxes.cpu().numpy(), scores.cpu().numpy(),
                       conf_threshold, iou_threshold, top_k)


def nms_decoded(boxes: np.ndarray, scores: np.ndarray, conf_threshold=0.01,
                iou_threshold=0.45, top_k=200):
    """:func:`detect`'s host half: per-class NMS and top-k over decoded
    ``boxes`` (B, P, 4) and ``scores`` (B, P, C+1) on the host."""
    results = []
    for b in range(boxes.shape[0]):
        all_boxes, all_scores, all_classes = [], [], []
        for c in range(1, scores.shape[-1]):          # skip background 0
            sc = scores[b, :, c]
            sel = sc > conf_threshold
            if not np.any(sel):
                continue
            idx = np.where(sel)[0]
            keep = nms_numpy(boxes[b, idx], sc[idx], iou_threshold, top_k)
            all_boxes.append(boxes[b, idx][keep])
            all_scores.append(sc[idx][keep])
            all_classes.append(np.full(len(keep), c - 1, np.int64))
        if all_boxes:
            bb = np.concatenate(all_boxes)
            ss = np.concatenate(all_scores)
            cc = np.concatenate(all_classes)
            order = np.argsort(-ss)[:top_k]
            results.append(dict(boxes=bb[order], scores=ss[order],
                                classes=cc[order]))
        else:
            results.append(dict(boxes=np.zeros((0, 4), np.float32),
                                scores=np.zeros((0,), np.float32),
                                classes=np.zeros((0,), np.int64)))
    return results


def visualize(image: np.ndarray, detections: dict, class_names=None,
              score_threshold=0.5) -> np.ndarray:
    """Draw boxes on an HWC uint8 image (reference Visualizer).  Pure
    numpy rectangle drawing; returns a copy."""
    img = np.asarray(image).copy()
    h, w = img.shape[:2]
    color = np.array([255, 64, 64], dtype=img.dtype)
    for box, score in zip(detections["boxes"], detections["scores"]):
        if score < score_threshold:
            continue
        x0 = int(np.clip(box[0] * w, 0, w - 1))
        y0 = int(np.clip(box[1] * h, 0, h - 1))
        x1 = int(np.clip(box[2] * w, 0, w - 1))
        y1 = int(np.clip(box[3] * h, 0, h - 1))
        img[y0:y1 + 1, x0] = color
        img[y0:y1 + 1, x1] = color
        img[y0, x0:x1 + 1] = color
        img[y1, x0:x1 + 1] = color
    return img
