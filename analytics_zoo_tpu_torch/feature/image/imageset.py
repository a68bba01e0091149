"""ImageSet — image dataset container (the port's own copy of
``analytics_zoo_tpu/feature/image/imageset.py``; reference
feature/image/ImageSet.scala:46-134, ``read`` :236).

Local folders of PNG/JPEG are decoded via PIL (imported lazily: a host
without pillow reads ``.npy`` arrays and raises the reference's error for
anything else).  A labeled
layout ``root/<class_name>/img`` yields integer labels like the reference's
``ImageSet.read(withLabel=true)``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing
from analytics_zoo_tpu_torch.feature.dataset import ArrayFeatureSet, FeatureSet

_IMG_EXT = (".png", ".jpg", ".jpeg", ".bmp", ".npy")


def _decode(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except ImportError as e:
        raise RuntimeError(
            "PIL unavailable; use .npy images or install pillow"
        ) from e


class ImageSet:
    """In-memory image collection with label support + transform chaining."""

    def __init__(self, images: Sequence[np.ndarray],
                 labels: Sequence | None = None,
                 paths: Sequence[str] | None = None,
                 label_map: dict | None = None):
        self.images = list(images)
        self.labels = None if labels is None else list(labels)
        self.paths = paths
        self.label_map = label_map

    @staticmethod
    def read(path: str, with_label: bool = False,
             max_images: int | None = None) -> "ImageSet":
        """Reference ImageSet.read (ImageSet.scala:236)."""
        images, labels, paths = [], [], []
        label_map = None
        if with_label:
            classes = sorted(
                d for d in os.listdir(path)
                if os.path.isdir(os.path.join(path, d))
            )
            label_map = {c: i for i, c in enumerate(classes)}
            for c in classes:
                if max_images and len(images) >= max_images:
                    break
                for f in sorted(os.listdir(os.path.join(path, c))):
                    if f.lower().endswith(_IMG_EXT):
                        p = os.path.join(path, c, f)
                        images.append(_decode(p))
                        labels.append(label_map[c])
                        paths.append(p)
                        if max_images and len(images) >= max_images:
                            break
        else:
            for f in sorted(os.listdir(path)):
                if f.lower().endswith(_IMG_EXT):
                    p = os.path.join(path, f)
                    images.append(_decode(p))
                    paths.append(p)
                    if max_images and len(images) >= max_images:
                        break
        return ImageSet(images, labels if with_label else None, paths,
                        label_map)

    @staticmethod
    def from_arrays(images, labels=None) -> "ImageSet":
        return ImageSet(list(images), None if labels is None else
                        list(labels))

    def transform(self, preprocessing: Preprocessing) -> "ImageSet":
        """Apply a transform chain eagerly (reference
        ImageSet.transform)."""
        return ImageSet([preprocessing(img) for img in self.images],
                        self.labels, self.paths, self.label_map)

    def to_feature_set(self) -> FeatureSet:
        x = np.stack([np.asarray(i, np.float32) for i in self.images])
        y = None if self.labels is None else np.asarray(self.labels)
        return ArrayFeatureSet(x, y)

    def __len__(self):
        return len(self.images)
