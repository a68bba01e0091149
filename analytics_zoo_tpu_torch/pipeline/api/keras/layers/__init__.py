"""Layers of the port: core, convolution, pooling, normalization, merge,
``SpaceToDepth`` and the transformer layers."""

from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (  # noqa
    Activation,
    Dense,
    Dropout,
    ExpandDim,
    Flatten,
    Identity,
    Permute,
    RepeatVector,
    Reshape,
    Squeeze,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (  # noqa
    AtrousConvolution1D,
    AtrousConvolution2D,
    Convolution1D,
    Convolution2D,
    Convolution3D,
    Cropping1D,
    Cropping2D,
    Cropping3D,
    UpSampling1D,
    UpSampling2D,
    UpSampling3D,
    ZeroPadding1D,
    ZeroPadding2D,
    ZeroPadding3D,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.pooling import (  # noqa
    AveragePooling1D,
    AveragePooling2D,
    AveragePooling3D,
    GlobalAveragePooling1D,
    GlobalAveragePooling2D,
    GlobalAveragePooling3D,
    GlobalMaxPooling1D,
    GlobalMaxPooling2D,
    GlobalMaxPooling3D,
    MaxPooling1D,
    MaxPooling2D,
    MaxPooling3D,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.normalization import (  # noqa
    BatchNormalization,
    LayerNormalization,
    recalibrate_batchnorm,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.merge import (  # noqa
    Merge,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.tensor_ops import (  # noqa
    SpaceToDepth,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (  # noqa
    self_attention as _self_attention,
)

BERT = _self_attention.BERT
TransformerLayer = _self_attention.TransformerLayer
