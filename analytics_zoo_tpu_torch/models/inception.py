"""Inception-v1 (GoogLeNet without its auxiliary classifiers) and
Inception-v3 on the graph ``Model`` API, channels-last.

Counterpart of ``analytics_zoo_tpu/models/inception.py``, with the same
layer names, so the same parameter and state trees (``params_from_jax``
carries a JAX model over unchanged).  ``Inception.v1`` is the reference's
flagship ImageNet training example, LRN2D(5, 1e-4, 0.75) after the first
pool and the second conv; ``inception_v3`` (``Inception.v3``) the
factorized 7x7 and asymmetric 1xN/Nx1 convolutions with a BatchNorm after
every conv, ``width`` scaling every tower's filters.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    LRN2D,
    Activation,
    AveragePooling2D,
    BatchNormalization,
    Convolution2D,
    Dense,
    Dropout,
    Flatten,
    GlobalAveragePooling2D,
    MaxPooling2D,
    Merge,
)

# (1x1, [3x3_reduce, 3x3], [5x5_reduce, 5x5], pool_proj) per block —
# inception.py:137-157 configs
_V1_BLOCKS = {
    "3a": (64, (96, 128), (16, 32), 32),
    "3b": (128, (128, 192), (32, 96), 64),
    "4a": (192, (96, 208), (16, 48), 64),
    "4b": (160, (112, 224), (24, 64), 64),
    "4c": (128, (128, 256), (24, 64), 64),
    "4d": (112, (144, 288), (32, 64), 64),
    "4e": (256, (160, 320), (32, 128), 128),
    "5a": (256, (160, 320), (32, 128), 128),
    "5b": (384, (192, 384), (48, 128), 128),
}


def _conv(x, filters, k, stride=1, name=None):
    return Convolution2D(filters, k, k, subsample=(stride, stride),
                         border_mode="same", activation="relu",
                         init="glorot_uniform", name=name)(x)


def _inception_block(x, key: str):
    """inception_layer_v1 (inception.py:83-117): 1x1 | 1x1->3x3 |
    1x1->5x5 | maxpool->1x1, channel-concat."""
    c1, (c3r, c3), (c5r, c5), cp = _V1_BLOCKS[key]
    p = f"inception_{key}/"
    t1 = _conv(x, c1, 1, name=p + "1x1")
    t2 = _conv(_conv(x, c3r, 1, name=p + "3x3_reduce"), c3, 3,
               name=p + "3x3")
    t3 = _conv(_conv(x, c5r, 1, name=p + "5x5_reduce"), c5, 5,
               name=p + "5x5")
    t4 = MaxPooling2D(pool_size=(3, 3), strides=(1, 1),
                      border_mode="same", name=p + "pool")(x)
    t4 = _conv(t4, cp, 1, name=p + "pool_proj")
    return Merge(mode="concat", concat_axis=-1, name=p + "output")(
        [t1, t2, t3, t4])


class Inception:
    """Factory namespace, like the reference companion objects."""

    @staticmethod
    def v1(classes: int = 1000, input_shape=(224, 224, 3),
           has_dropout: bool = True) -> Model:
        """Inception_v1_NoAuxClassifier
        (inception.py:119-165 layer-for-layer)."""
        inp = Input(shape=input_shape, name="input")
        x = _conv(inp, 64, 7, stride=2, name="conv1/7x7_s2")
        x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                         border_mode="same", name="pool1/3x3_s2")(x)
        x = LRN2D(alpha=1e-4, k=1.0, beta=0.75, n=5,
                  name="pool1/norm1")(x)
        x = _conv(x, 64, 1, name="conv2/3x3_reduce")
        x = _conv(x, 192, 3, name="conv2/3x3")
        x = LRN2D(alpha=1e-4, k=1.0, beta=0.75, n=5, name="conv2/norm2")(x)
        x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                         border_mode="same", name="pool2/3x3_s2")(x)
        x = _inception_block(x, "3a")
        x = _inception_block(x, "3b")
        x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                         border_mode="same", name="pool3/3x3_s2")(x)
        for key in ("4a", "4b", "4c", "4d", "4e"):
            x = _inception_block(x, key)
        x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                         border_mode="same", name="pool4/3x3_s2")(x)
        x = _inception_block(x, "5a")
        x = _inception_block(x, "5b")
        pool = input_shape[0] // 32
        x = AveragePooling2D(pool_size=(pool, pool), strides=(1, 1),
                             name="pool5")(x)
        x = Flatten()(x)
        if has_dropout:
            x = Dropout(0.4, name="pool5/drop")(x)
        out = Dense(classes, activation="softmax",
                    name="loss3/classifier")(x)
        return Model(inp, out, name="inception_v1")


# ---------------------------------------------------------------------------
# Inception-v3 (reference inception-v3 config,
# ImageClassificationConfig.scala:35-36; Szegedy 2015 "Rethinking the
# Inception Architecture" — factorized 7x7 and asymmetric 1xN/Nx1 convs,
# BN after every conv)
# ---------------------------------------------------------------------------

def _cbn(x, filters, kr, kc=None, stride=1, mode="same", name=None,
         bn_momentum=0.99):
    """conv (no bias) + BN + relu — the v3 building unit."""
    kc = kc if kc is not None else kr
    y = Convolution2D(filters, kr, kc, subsample=(stride, stride),
                      border_mode=mode, bias=False, name=f"{name}/conv")(x)
    y = BatchNormalization(momentum=bn_momentum, name=f"{name}/bn")(y)
    return Activation("relu", name=f"{name}/relu")(y)


def _v3_pool_proj(x, ch, name, bn_momentum):
    p = AveragePooling2D(pool_size=(3, 3), strides=(1, 1),
                         border_mode="same", name=f"{name}/pool")(x)
    return _cbn(p, ch, 1, name=f"{name}/pool_proj",
                bn_momentum=bn_momentum)


def _v3_block_a(x, c, pool_ch, name, m):
    """35x35 module: 1x1 | 5x5 | double-3x3 | pool-proj."""
    b1 = _cbn(x, c(64), 1, name=f"{name}/1x1", bn_momentum=m)
    b5 = _cbn(x, c(48), 1, name=f"{name}/5x5_reduce", bn_momentum=m)
    b5 = _cbn(b5, c(64), 5, name=f"{name}/5x5", bn_momentum=m)
    b3 = _cbn(x, c(64), 1, name=f"{name}/3x3dbl_reduce", bn_momentum=m)
    b3 = _cbn(b3, c(96), 3, name=f"{name}/3x3dbl_1", bn_momentum=m)
    b3 = _cbn(b3, c(96), 3, name=f"{name}/3x3dbl_2", bn_momentum=m)
    bp = _v3_pool_proj(x, c(pool_ch), name, m)
    return Merge(mode="concat", concat_axis=-1, name=f"{name}/concat")(
        [b1, b5, b3, bp])


def _v3_reduction_a(x, c, name, m):
    b3 = _cbn(x, c(384), 3, stride=2, mode="valid",
              name=f"{name}/3x3", bn_momentum=m)
    bd = _cbn(x, c(64), 1, name=f"{name}/3x3dbl_reduce", bn_momentum=m)
    bd = _cbn(bd, c(96), 3, name=f"{name}/3x3dbl_1", bn_momentum=m)
    bd = _cbn(bd, c(96), 3, stride=2, mode="valid",
              name=f"{name}/3x3dbl_2", bn_momentum=m)
    bp = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                      name=f"{name}/pool")(x)
    return Merge(mode="concat", concat_axis=-1, name=f"{name}/concat")(
        [b3, bd, bp])


def _v3_block_b(x, c, mid, name, m):
    """17x17 module: 1x1 | 1x7-7x1 | double 7x7 | pool-proj (factorized
    asymmetric convolutions — the paper's signature)."""
    b1 = _cbn(x, c(192), 1, name=f"{name}/1x1", bn_momentum=m)
    b7 = _cbn(x, c(mid), 1, name=f"{name}/7x7_reduce", bn_momentum=m)
    b7 = _cbn(b7, c(mid), 1, 7, name=f"{name}/7x7_1x7", bn_momentum=m)
    b7 = _cbn(b7, c(192), 7, 1, name=f"{name}/7x7_7x1", bn_momentum=m)
    bd = _cbn(x, c(mid), 1, name=f"{name}/7x7dbl_reduce", bn_momentum=m)
    bd = _cbn(bd, c(mid), 7, 1, name=f"{name}/7x7dbl_1", bn_momentum=m)
    bd = _cbn(bd, c(mid), 1, 7, name=f"{name}/7x7dbl_2", bn_momentum=m)
    bd = _cbn(bd, c(mid), 7, 1, name=f"{name}/7x7dbl_3", bn_momentum=m)
    bd = _cbn(bd, c(192), 1, 7, name=f"{name}/7x7dbl_4", bn_momentum=m)
    bp = _v3_pool_proj(x, c(192), name, m)
    return Merge(mode="concat", concat_axis=-1, name=f"{name}/concat")(
        [b1, b7, bd, bp])


def _v3_reduction_b(x, c, name, m):
    b3 = _cbn(x, c(192), 1, name=f"{name}/3x3_reduce", bn_momentum=m)
    b3 = _cbn(b3, c(320), 3, stride=2, mode="valid",
              name=f"{name}/3x3", bn_momentum=m)
    b7 = _cbn(x, c(192), 1, name=f"{name}/7x7_reduce", bn_momentum=m)
    b7 = _cbn(b7, c(192), 1, 7, name=f"{name}/7x7_1x7", bn_momentum=m)
    b7 = _cbn(b7, c(192), 7, 1, name=f"{name}/7x7_7x1", bn_momentum=m)
    b7 = _cbn(b7, c(192), 3, stride=2, mode="valid",
              name=f"{name}/7x7_3x3", bn_momentum=m)
    bp = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                      name=f"{name}/pool")(x)
    return Merge(mode="concat", concat_axis=-1, name=f"{name}/concat")(
        [b3, b7, bp])


def _v3_block_c(x, c, name, m):
    """8x8 module: 1x1 | 3x3-split(1x3 + 3x1) | dbl-3x3-split | pool."""
    b1 = _cbn(x, c(320), 1, name=f"{name}/1x1", bn_momentum=m)
    b3 = _cbn(x, c(384), 1, name=f"{name}/3x3_reduce", bn_momentum=m)
    b3a = _cbn(b3, c(384), 1, 3, name=f"{name}/3x3_1x3", bn_momentum=m)
    b3b = _cbn(b3, c(384), 3, 1, name=f"{name}/3x3_3x1", bn_momentum=m)
    bd = _cbn(x, c(448), 1, name=f"{name}/dbl_reduce", bn_momentum=m)
    bd = _cbn(bd, c(384), 3, name=f"{name}/dbl_3x3", bn_momentum=m)
    bda = _cbn(bd, c(384), 1, 3, name=f"{name}/dbl_1x3", bn_momentum=m)
    bdb = _cbn(bd, c(384), 3, 1, name=f"{name}/dbl_3x1", bn_momentum=m)
    bp = _v3_pool_proj(x, c(192), name, m)
    return Merge(mode="concat", concat_axis=-1, name=f"{name}/concat")(
        [b1, b3a, b3b, bda, bdb, bp])


def inception_v3(classes: int = 1000, input_shape=(299, 299, 3),
                 width: float = 1.0, has_dropout: bool = True,
                 bn_momentum: float = 0.99) -> Model:
    """Inception-v3 (299x299 canonical; any input >= ~75px works).
    ``width`` scales every tower's filter count (toy sizes in tests)."""
    def c(ch):
        return max(int(ch * width), 4)

    m = bn_momentum
    inp = Input(shape=input_shape, name="input")
    x = _cbn(inp, c(32), 3, stride=2, mode="valid", name="stem/conv1",
             bn_momentum=m)
    x = _cbn(x, c(32), 3, mode="valid", name="stem/conv2", bn_momentum=m)
    x = _cbn(x, c(64), 3, name="stem/conv3", bn_momentum=m)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                     name="stem/pool1")(x)
    x = _cbn(x, c(80), 1, mode="valid", name="stem/conv4", bn_momentum=m)
    x = _cbn(x, c(192), 3, mode="valid", name="stem/conv5", bn_momentum=m)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                     name="stem/pool2")(x)
    x = _v3_block_a(x, c, 32, "mixed_5b", m)
    x = _v3_block_a(x, c, 64, "mixed_5c", m)
    x = _v3_block_a(x, c, 64, "mixed_5d", m)
    x = _v3_reduction_a(x, c, "mixed_6a", m)
    x = _v3_block_b(x, c, 128, "mixed_6b", m)
    x = _v3_block_b(x, c, 160, "mixed_6c", m)
    x = _v3_block_b(x, c, 160, "mixed_6d", m)
    x = _v3_block_b(x, c, 192, "mixed_6e", m)
    x = _v3_reduction_b(x, c, "mixed_7a", m)
    x = _v3_block_c(x, c, "mixed_7b", m)
    x = _v3_block_c(x, c, "mixed_7c", m)
    x = GlobalAveragePooling2D(name="pool")(x)
    if has_dropout:
        x = Dropout(0.2, name="dropout")(x)
    out = Dense(classes, activation="softmax", name="classifier")(x)
    return Model(inp, out, name="inception_v3")


Inception.v3 = staticmethod(inception_v3)
