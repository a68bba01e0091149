"""MultiBox loss — matching, offset encoding, hard-negative mining
(counterpart of ``analytics_zoo_tpu/models/image/objectdetection/
multibox_loss.py``).

Reference: objectdetection/common/loss/MultiBoxLoss.scala (smooth-L1 loc
loss on matched priors + softmax conf loss with 3:1 hard-negative mining).

Everything is static-shape torch inside the captured train step: ground
truth arrives padded to ``max_boxes`` per image (label -1 = padding), the
matching is batched IoU + argmax, and the reference's *sequential
bipartite* force-match (each round claims the globally best unmatched
(prior, gt) pair, so every gt owns a distinct prior even when two gts
share the same best prior) is one loop of ``max_boxes`` rounds over the
whole batch, where the JAX package runs a ``lax.fori_loop`` per image under
``vmap``.  Each round is a handful of elementwise kernels on the (B, P, M)
matrix with no host sync, so a captured step replays them.  Hard-negative
mining ranks by a stable argsort of a stable argsort (``jnp.argsort`` is
stable): tied negative losses pick the same priors in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.image.objectdetection.priors import (
    center_to_corner,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import LossFunction


def iou_matrix(a_corner, b_corner):
    """Pairwise IoU: a (..., Na, 4), b (..., Nb, 4) corner boxes ->
    (..., Na, Nb)."""
    lo = torch.maximum(a_corner[..., :, None, 0:2],
                       b_corner[..., None, :, 0:2])
    hi = torch.minimum(a_corner[..., :, None, 2:4],
                       b_corner[..., None, :, 2:4])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    area_a = torch.prod(a_corner[..., 2:4] - a_corner[..., 0:2], dim=-1)
    area_b = torch.prod(b_corner[..., 2:4] - b_corner[..., 0:2], dim=-1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def encode_boxes(matched_corner, priors_center, variances=(0.1, 0.2)):
    """gt corner boxes -> regression targets w.r.t. priors (SSD encoding)."""
    wh = matched_corner[..., 2:4] - matched_corner[..., 0:2]
    c = matched_corner[..., 0:2] + 0.5 * wh
    d_c = (c - priors_center[..., 0:2]) / (
        priors_center[..., 2:4] * variances[0])
    d_wh = torch.log(torch.clamp(wh / priors_center[..., 2:4], min=1e-8)) \
        / variances[1]
    return torch.cat([d_c, d_wh], dim=-1)


def decode_boxes(loc, priors_center, variances=(0.1, 0.2)):
    """Regression outputs -> corner boxes (inverse of encode_boxes)."""
    c = priors_center[..., 0:2] + loc[..., 0:2] * variances[0] * \
        priors_center[..., 2:4]
    wh = priors_center[..., 2:4] * torch.exp(loc[..., 2:4] * variances[1])
    lo = c - 0.5 * wh
    hi = c + 0.5 * wh
    return torch.cat([lo, hi], dim=-1)


def _bipartite_force(iou, valid):
    """Sequential bipartite matching over a batch: ``max_boxes`` rounds,
    each claiming every image's globally best remaining (prior, gt) pair
    and retiring that prior row and gt column (the reference's mutable
    bipartite pass).  ``iou`` (B, P, M), ``valid`` (B, M); returns the
    (B, P, M) force matrix with 2.0 at the claimed pairs.  ``argmax``
    takes the first maximum, as ``jnp.argmax`` does."""
    b, p, m = iou.shape
    work = torch.where(valid[:, None, :], iou, -1.0)
    force = torch.zeros_like(iou)
    prior_ids = torch.arange(p, device=iou.device)
    gt_ids = torch.arange(m, device=iou.device)
    for _ in range(m):
        flat = work.reshape(b, p * m)
        idx = torch.argmax(flat, dim=1)
        ok = torch.gather(flat, 1, idx[:, None]) >= 0.0       # (B, 1)
        hit_p = (prior_ids[None, :] == (idx // m)[:, None]) & ok
        hit_g = (gt_ids[None, :] == (idx % m)[:, None]) & ok
        force = torch.where(hit_p[:, :, None] & hit_g[:, None, :], 2.0,
                            force)
        work = torch.where(hit_p[:, :, None] | hit_g[:, None, :], -1.0,
                           work)
    return force


def match_priors(gt_corner, gt_labels, priors_corner, iou_threshold=0.5):
    """Matching for one image or a batch.

    Args:
      gt_corner: (max_boxes, 4) or (B, max_boxes, 4) padded gt corner
        boxes.
      gt_labels: (max_boxes,) or (B, max_boxes) class ids in [0, C); -1
        marks padding.
      priors_corner: (P, 4).

    Returns:
      (conf_target (..., P) int64 with 0 = background and label+1
      otherwise, matched_corner (..., P, 4) the gt box each prior regresses
      to).
    """
    single = gt_corner.dim() == 2
    if single:
        gt_corner, gt_labels = gt_corner[None], gt_labels[None]
    gt_labels = gt_labels.long()
    valid = gt_labels >= 0                               # (B, M)
    iou = iou_matrix(priors_corner, gt_corner)           # (B, P, M)
    iou = torch.where(valid[:, None, :], iou, -1.0)

    # force-match: the bipartite pass gives each valid gt a distinct prior
    iou = torch.maximum(iou, _bipartite_force(iou, valid))
    best_gt = torch.argmax(iou, dim=2)                   # (B, P), first max
    best_gt_iou = torch.amax(iou, dim=2)

    matched_corner = torch.gather(
        gt_corner, 1, best_gt[..., None].expand(-1, -1, 4))   # (B, P, 4)
    matched_label = torch.gather(gt_labels, 1, best_gt)       # (B, P)
    positive = best_gt_iou >= iou_threshold
    conf_target = torch.where(positive, matched_label + 1, 0)
    if single:
        return conf_target[0], matched_corner[0]
    return conf_target, matched_corner


def _smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


class MultiBoxLoss(LossFunction):
    """SSD loss over concatenated (loc, conf-logits) model output.

    ``y_pred``: (B, P, 4 + C+1) — 4 loc offsets then C+1 class logits
    (class 0 = background).  ``y_true``: (B, max_boxes, 5) rows of
    (xmin, ymin, xmax, ymax, label) with label -1 padding.

    Reference MultiBoxLoss.scala: loc smooth-L1 over positives + conf
    cross-entropy over positives and the top-(neg_pos_ratio x n_pos)
    hardest negatives, normalized by n_pos.  The priors are held as numpy
    and moved to a device once, at the first call there (the eager run
    before a capture), so a captured step copies nothing from the host.
    """

    def __init__(self, priors: np.ndarray, n_classes: int,
                 iou_threshold=0.5, neg_pos_ratio=3.0,
                 variances=(0.1, 0.2), loc_weight=1.0):
        self.priors_center = np.asarray(priors, np.float32)
        self.priors_corner = np.asarray(center_to_corner(priors),
                                        np.float32)
        self.n_classes = n_classes
        self.iou_threshold = iou_threshold
        self.neg_pos_ratio = neg_pos_ratio
        self.variances = variances
        self.loc_weight = loc_weight
        self._on_device: dict = {}
        super().__init__(self._fn, "multibox")

    def priors_on(self, device) -> tuple:
        """(priors_center, priors_corner) as f32 tensors on ``device``."""
        key = torch.device(device)
        got = self._on_device.get(key)
        if got is None:
            got = self._on_device[key] = (
                torch.from_numpy(self.priors_center).to(key),
                torch.from_numpy(self.priors_corner).to(key))
        return got

    def _fn(self, y_true, y_pred):
        priors_center, priors_corner = self.priors_on(y_pred.device)
        loc = y_pred[..., :4]                            # (B, P, 4)
        logits = y_pred[..., 4:]                         # (B, P, C+1)
        gt_boxes = y_true[..., :4]
        gt_labels = y_true[..., 4].long()

        conf_t, matched = match_priors(gt_boxes, gt_labels, priors_corner,
                                       self.iou_threshold)

        pos = conf_t > 0                                 # (B, P)
        n_pos = torch.sum(pos, dim=1)                    # (B,)

        loc_t = encode_boxes(matched, priors_center, self.variances)
        loc_loss = torch.sum(
            torch.where(pos[..., None], _smooth_l1(loc - loc_t), 0.0),
            dim=(1, 2))

        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, -1, conf_t[..., None])[..., 0]

        # hard negative mining: per image rank negatives by ce descending;
        # keep rank < neg_pos_ratio * n_pos (rank-of-rank keeps the shapes
        # static in a captured step)
        neg_ce = torch.where(pos, -torch.inf, ce)
        order = torch.argsort(-neg_ce, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        n_neg = torch.minimum(
            (self.neg_pos_ratio * n_pos).long(), torch.sum(~pos, dim=1))
        neg = rank < n_neg[:, None]
        conf_loss = torch.sum(torch.where(pos | neg, ce, 0.0), dim=1)

        denom = torch.clamp(n_pos.float(), min=1.0)
        return (self.loc_weight * loc_loss + conf_loss) / denom
