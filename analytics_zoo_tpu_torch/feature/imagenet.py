"""ImageNet-directory ingestion (the port's own copy of
``analytics_zoo_tpu/feature/imagenet.py``).

Accepts either TFRecord shards (``*.tfrecord`` or ``train-*-of-*``, the
standard ImageNet layout: ``image/encoded`` JPEG + 1-based
``image/class/label``) or ``.npz`` shards (``x`` uint8 HWC images + ``y``
labels).  Reference role: the ImageNet loaders of
examples/inception/ImageNet2012.scala and the resnet example's shard
reading.  TFRecord JPEGs decode through cv2; ``.npz`` shards need only
numpy.
"""

from __future__ import annotations

import glob
import os

from analytics_zoo_tpu_torch.feature.dataset import FeatureSet


def imagenet_feature_set(data_dir: str,
                         image_size: int = 224) -> FeatureSet:
    """FeatureSet over an ImageNet-layout directory (uint8 images out;
    normalization belongs on device via ``transform_on_device``)."""
    tfrec = sorted(glob.glob(os.path.join(data_dir, "*.tfrecord"))
                   + glob.glob(os.path.join(data_dir, "train-*-of-*")))
    if tfrec:
        from analytics_zoo_tpu_torch.feature.tfrecord import (
            imagenet_example_parser,
        )

        return FeatureSet.from_tfrecord(
            tfrec, imagenet_example_parser(image_size=image_size,
                                           label_offset=-1))
    npz = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not npz:
        raise FileNotFoundError(
            f"{data_dir}: no TFRecord (*.tfrecord / train-*-of-*) or .npz "
            "shards found")
    return FeatureSet.from_shards(npz)
