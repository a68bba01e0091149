"""Image classification zoo (reference
zoo/.../models/image/imageclassification): ImageClassifier with per-model
preprocessing configs and LabelOutput postprocess."""

from analytics_zoo_tpu_torch.models.image.imageclassification.classifier import (
    ImageClassificationConfig,
    ImageClassifier,
    ImagenetConfig,
    LabelOutput,
)

__all__ = [
    "ImageClassifier",
    "ImageClassificationConfig",
    "ImagenetConfig",
    "LabelOutput",
]
