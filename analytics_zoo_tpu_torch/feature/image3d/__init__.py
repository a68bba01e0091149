"""3D (medical) image transforms — reference zoo/.../feature/image3d
(AffineTransform3D, Crop3D variants, Rotate3D, Warp.scala flow-field
warp)."""

from analytics_zoo_tpu_torch.feature.image3d.transforms import (
    AffineTransform3D,
    CenterCrop3D,
    Crop3D,
    RandomCrop3D,
    Rotate3D,
    Warp3D,
    rotation_matrix_3d,
)

__all__ = [
    "AffineTransform3D",
    "Crop3D",
    "CenterCrop3D",
    "RandomCrop3D",
    "Rotate3D",
    "Warp3D",
    "rotation_matrix_3d",
]
