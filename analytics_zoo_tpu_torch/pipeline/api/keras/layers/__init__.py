"""Layers of the port: core, convolution, pooling, normalization, merge,
the tensor ops, the embeddings, the recurrent layers, the advanced
activations and the transformer layers.  The core, convolution,
normalization, tensor-op, embedding, recurrent and advanced modules export
every name the reference's modules do."""

from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (  # noqa
    Activation,
    Dense,
    Dropout,
    ExpandDim,
    Flatten,
    GaussianDropout,
    GaussianNoise,
    Highway,
    Identity,
    Masking,
    MaxoutDense,
    Permute,
    RepeatVector,
    Reshape,
    Select,
    SparseDense,
    SpatialDropout1D,
    SpatialDropout2D,
    SpatialDropout3D,
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
    Deconvolution2D,
    DepthwiseConvolution2D,
    LocallyConnected1D,
    LocallyConnected2D,
    SeparableConvolution2D,
    ShareConvolution2D,
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
    WithinChannelLRN2D,
    recalibrate_batchnorm,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.merge import (  # noqa
    Merge,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.tensor_ops import (  # noqa
    LRN2D,
    AddConstant,
    BinaryThreshold,
    CAdd,
    CMul,
    Exp,
    Expand,
    GaussianSampler,
    GetShape,
    HardShrink,
    HardTanh,
    Log,
    Max,
    Mul,
    MulConstant,
    Narrow,
    Negative,
    Power,
    ResizeBilinear,
    RReLU,
    Scale,
    SelectTable,
    Softmax,
    SoftShrink,
    SpaceToDepth,
    SplitTensor,
    Sqrt,
    Square,
    Threshold,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding import (  # noqa
    Embedding,
    SparseEmbedding,
    WordEmbedding,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.recurrent import (  # noqa
    GRU,
    LSTM,
    Bidirectional,
    ConvLSTM2D,
    ConvLSTM3D,
    SimpleRNN,
    TimeDistributed,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.advanced import (  # noqa
    ELU,
    LeakyReLU,
    ParametricSoftPlus,
    PReLU,
    SReLU,
    ThresholdedReLU,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (  # noqa
    self_attention as _self_attention,
)

BERT = _self_attention.BERT
TransformerLayer = _self_attention.TransformerLayer
