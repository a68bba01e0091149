"""SSD prior (anchor) boxes (the port's copy of
``analytics_zoo_tpu/models/image/objectdetection/priors.py``).

Reference: objectdetection/common/PriorBox generation used by the SSD-VGG
graph (reference ssd/SSDGraph.scala:56, ssd/SSD.scala:55-78).  Priors are a
*static* function of the feature-map geometry, so they are precomputed once
in numpy and held by the loss and postprocess as device constants — no
per-step prior computation as in the reference's per-layer PriorBox modules.

Boxes are normalized to [0, 1], stored center-size ``(cx, cy, w, h)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


class PriorSpec:
    """One feature map's anchor config (reference ComponetParam in
    ssd/SSD.scala)."""

    def __init__(self, fm_size: int, min_size: float, max_size: float,
                 aspect_ratios: Sequence[float], step: float | None = None):
        self.fm_size = fm_size
        self.min_size = min_size
        self.max_size = max_size
        self.aspect_ratios = tuple(aspect_ratios)
        self.step = step

    @property
    def boxes_per_loc(self) -> int:
        # min, sqrt(min*max), and 2 per extra aspect ratio (ar, 1/ar)
        return 2 + 2 * len(self.aspect_ratios)


# SSD-300 VGG16 standard config: 38/19/10/5/3/1 maps, 8732 priors.
SSD300_SPECS = [
    PriorSpec(38, 30 / 300, 60 / 300, (2.0,)),
    PriorSpec(19, 60 / 300, 111 / 300, (2.0, 3.0)),
    PriorSpec(10, 111 / 300, 162 / 300, (2.0, 3.0)),
    PriorSpec(5, 162 / 300, 213 / 300, (2.0, 3.0)),
    PriorSpec(3, 213 / 300, 264 / 300, (2.0,)),
    PriorSpec(1, 264 / 300, 315 / 300, (2.0,)),
]


def generate_priors(specs: Sequence[PriorSpec]) -> np.ndarray:
    """(n_priors, 4) center-size normalized anchors."""
    out = []
    for spec in specs:
        f = spec.fm_size
        step = spec.step if spec.step is not None else 1.0 / f
        for i in range(f):
            for j in range(f):
                cx = (j + 0.5) * step
                cy = (i + 0.5) * step
                s = spec.min_size
                out.append([cx, cy, s, s])
                sp = math.sqrt(spec.min_size * spec.max_size)
                out.append([cx, cy, sp, sp])
                for ar in spec.aspect_ratios:
                    r = math.sqrt(ar)
                    out.append([cx, cy, s * r, s / r])
                    out.append([cx, cy, s / r, s * r])
    return np.clip(np.asarray(out, np.float32), 0.0, 1.0)


def center_to_corner(boxes):
    """(cx, cy, w, h) -> (xmin, ymin, xmax, ymax)."""
    boxes = np.asarray(boxes)
    half = 0.5 * boxes[..., 2:4]
    lo = boxes[..., 0:2] - half
    hi = boxes[..., 0:2] + half
    return np.concatenate([lo, hi], axis=-1)
