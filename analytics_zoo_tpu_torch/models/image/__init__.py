"""Image model zoo: classification + object detection (reference
zoo/.../models/image)."""

from analytics_zoo_tpu_torch.models.image.objectdetection import (  # noqa: F401
    MultiBoxLoss,
    ObjectDetector,
)
