"""The rest of the ImageNet classification set: AlexNet, VGG-16/19,
SqueezeNet, DenseNet-121/161, MobileNet and MobileNet-v2, channels-last.

Counterpart of ``analytics_zoo_tpu/models/imagenet_zoo.py`` (the
reference's ``ImageClassificationConfig.scala:31-50`` model set;
Inception-v1 and ResNet-50 live in their own modules), builder for builder
with the same layer names, so the same parameter and state trees.  Every
builder takes ``classes`` and ``input_shape`` and a width or depth knob
(``width``, ``alpha``, ``growth_rate``/``block_plan``) whose defaults are
the papers' filter plans.  The reference's ``*-quantize`` and ``*-int8``
variants are ``InferenceModel.optimize("int8")`` on these graphs.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model, Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    LRN2D,
    Activation,
    AveragePooling2D,
    BatchNormalization,
    Convolution2D,
    Dense,
    DepthwiseConvolution2D,
    Dropout,
    Flatten,
    GlobalAveragePooling2D,
    MaxPooling2D,
    Merge,
)


def _concat(tensors, name=None):
    return Merge(mode="concat", concat_axis=-1, name=name)(tensors)


# ---------------------------------------------------------------------------
# AlexNet (reference alexnet config; Krizhevsky 2012 filter plan)
# ---------------------------------------------------------------------------

def alexnet(classes: int = 1000, input_shape=(227, 227, 3),
            width: float = 1.0, has_dropout: bool = True) -> Sequential:
    def c(ch):
        return max(int(ch * width), 4)

    m = Sequential(name="alexnet")
    m.add(Convolution2D(c(96), 11, 11, subsample=(4, 4), activation="relu",
                        input_shape=input_shape, name="conv1"))
    m.add(MaxPooling2D((3, 3), strides=(2, 2), name="pool1"))
    # LRN placement matches the reference net (bvlc_alexnet: norm1/norm2
    # after the first two pooling stages)
    m.add(LRN2D(alpha=1e-4, k=1.0, beta=0.75, n=5, name="norm1"))
    m.add(Convolution2D(c(256), 5, 5, border_mode="same",
                        activation="relu", name="conv2"))
    m.add(MaxPooling2D((3, 3), strides=(2, 2), name="pool2"))
    m.add(LRN2D(alpha=1e-4, k=1.0, beta=0.75, n=5, name="norm2"))
    m.add(Convolution2D(c(384), 3, 3, border_mode="same",
                        activation="relu", name="conv3"))
    m.add(Convolution2D(c(384), 3, 3, border_mode="same",
                        activation="relu", name="conv4"))
    m.add(Convolution2D(c(256), 3, 3, border_mode="same",
                        activation="relu", name="conv5"))
    m.add(MaxPooling2D((3, 3), strides=(2, 2), name="pool5"))
    m.add(Flatten(name="flatten"))
    m.add(Dense(c(4096), activation="relu", name="fc6"))
    if has_dropout:
        m.add(Dropout(0.5, name="drop6"))
    m.add(Dense(c(4096), activation="relu", name="fc7"))
    if has_dropout:
        m.add(Dropout(0.5, name="drop7"))
    m.add(Dense(classes, activation="softmax", name="fc8"))
    return m


# ---------------------------------------------------------------------------
# VGG-16 / VGG-19 (reference vgg-16/vgg-19 configs; Simonyan 2014 plan D/E)
# ---------------------------------------------------------------------------

_VGG_PLANS = {
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


def vgg(depth: int = 16, classes: int = 1000, input_shape=(224, 224, 3),
        width: float = 1.0, has_dropout: bool = True) -> Sequential:
    if depth not in _VGG_PLANS:
        raise ValueError(f"vgg depth must be one of {sorted(_VGG_PLANS)}")

    def c(ch):
        return max(int(ch * width), 4)

    m = Sequential(name=f"vgg_{depth}")
    first = True
    for block, (n_convs, ch) in enumerate(
            zip(_VGG_PLANS[depth], (64, 128, 256, 512, 512)), start=1):
        for i in range(n_convs):
            kw = {"input_shape": input_shape} if first else {}
            first = False
            m.add(Convolution2D(c(ch), 3, 3, border_mode="same",
                                activation="relu",
                                name=f"conv{block}_{i + 1}", **kw))
        m.add(MaxPooling2D((2, 2), name=f"pool{block}"))
    m.add(Flatten(name="flatten"))
    m.add(Dense(c(4096), activation="relu", name="fc6"))
    if has_dropout:
        m.add(Dropout(0.5, name="drop6"))
    m.add(Dense(c(4096), activation="relu", name="fc7"))
    if has_dropout:
        m.add(Dropout(0.5, name="drop7"))
    m.add(Dense(classes, activation="softmax", name="fc8"))
    return m


# ---------------------------------------------------------------------------
# SqueezeNet (reference squeezenet config; Iandola 2016 fire modules)
# ---------------------------------------------------------------------------

def _fire(x, squeeze, expand, name):
    s = Convolution2D(squeeze, 1, 1, activation="relu",
                      name=f"{name}/squeeze1x1")(x)
    e1 = Convolution2D(expand, 1, 1, activation="relu",
                       name=f"{name}/expand1x1")(s)
    e3 = Convolution2D(expand, 3, 3, border_mode="same", activation="relu",
                       name=f"{name}/expand3x3")(s)
    return _concat([e1, e3], name=f"{name}/concat")


def squeezenet(classes: int = 1000, input_shape=(224, 224, 3),
               width: float = 1.0) -> Model:
    def c(ch):
        return max(int(ch * width), 2)

    inp = Input(shape=input_shape, name="input")
    x = Convolution2D(c(64), 3, 3, subsample=(2, 2), activation="relu",
                      name="conv1")(inp)
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool1")(x)
    x = _fire(x, c(16), c(64), "fire2")
    x = _fire(x, c(16), c(64), "fire3")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool3")(x)
    x = _fire(x, c(32), c(128), "fire4")
    x = _fire(x, c(32), c(128), "fire5")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool5")(x)
    x = _fire(x, c(48), c(192), "fire6")
    x = _fire(x, c(48), c(192), "fire7")
    x = _fire(x, c(64), c(256), "fire8")
    x = _fire(x, c(64), c(256), "fire9")
    x = Convolution2D(classes, 1, 1, activation="relu", name="conv10")(x)
    x = GlobalAveragePooling2D(name="pool10")(x)
    out = Activation("softmax", name="prob")(x)
    return Model(inp, out, name="squeezenet")


# ---------------------------------------------------------------------------
# DenseNet (reference densenet-161 config; Huang 2017 — dense blocks with
# BN-ReLU-1x1 / BN-ReLU-3x3 composite layers and transition compression)
# ---------------------------------------------------------------------------

_DENSENET_PLANS = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24)}


def _dense_layer(x, growth, name):
    y = BatchNormalization(name=f"{name}/bn1")(x)
    y = Activation("relu", name=f"{name}/relu1")(y)
    y = Convolution2D(4 * growth, 1, 1, bias=False,
                      name=f"{name}/conv1x1")(y)
    y = BatchNormalization(name=f"{name}/bn2")(y)
    y = Activation("relu", name=f"{name}/relu2")(y)
    y = Convolution2D(growth, 3, 3, border_mode="same", bias=False,
                      name=f"{name}/conv3x3")(y)
    return _concat([x, y], name=f"{name}/concat")


def densenet(depth: int = 161, classes: int = 1000,
             input_shape=(224, 224, 3), growth_rate: int | None = None,
             block_plan=None, init_features: int | None = None) -> Model:
    if block_plan is None:
        if depth not in _DENSENET_PLANS:
            raise ValueError(
                f"densenet depth must be one of {sorted(_DENSENET_PLANS)}")
        block_plan = _DENSENET_PLANS[depth]
    growth = growth_rate or (48 if depth == 161 else 32)
    feats = init_features or 2 * growth

    inp = Input(shape=input_shape, name="input")
    x = Convolution2D(feats, 7, 7, subsample=(2, 2), border_mode="same",
                      bias=False, name="conv0")(inp)
    x = BatchNormalization(name="bn0")(x)
    x = Activation("relu", name="relu0")(x)
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="pool0")(x)
    ch = feats
    for b, n_layers in enumerate(block_plan, start=1):
        for i in range(n_layers):
            x = _dense_layer(x, growth, f"block{b}/layer{i + 1}")
            ch += growth
        if b != len(block_plan):   # transition: BN-ReLU-1x1(0.5x)-avgpool
            x = BatchNormalization(name=f"trans{b}/bn")(x)
            x = Activation("relu", name=f"trans{b}/relu")(x)
            ch = ch // 2
            x = Convolution2D(ch, 1, 1, bias=False,
                              name=f"trans{b}/conv")(x)
            x = AveragePooling2D((2, 2), name=f"trans{b}/pool")(x)
    x = BatchNormalization(name="bn_final")(x)
    x = Activation("relu", name="relu_final")(x)
    x = GlobalAveragePooling2D(name="pool_final")(x)
    out = Dense(classes, activation="softmax", name="classifier")(x)
    return Model(inp, out, name=f"densenet_{depth}")


# ---------------------------------------------------------------------------
# MobileNet v1 (reference mobilenet config; Howard 2017 — depthwise
# separable blocks with BN between the depthwise and pointwise stages,
# which is why DepthwiseConvolution2D exists as a standalone layer)
# ---------------------------------------------------------------------------

def _dw_block(x, ch, stride, name, bn_momentum=0.99):
    y = DepthwiseConvolution2D(3, 3, subsample=(stride, stride),
                               border_mode="same", bias=False,
                               name=f"{name}/dw")(x)
    y = BatchNormalization(momentum=bn_momentum, name=f"{name}/dw_bn")(y)
    y = Activation("relu", name=f"{name}/dw_relu")(y)
    y = Convolution2D(ch, 1, 1, bias=False, name=f"{name}/pw")(y)
    y = BatchNormalization(momentum=bn_momentum, name=f"{name}/pw_bn")(y)
    return Activation("relu", name=f"{name}/pw_relu")(y)


_MOBILENET_PLAN = (  # (out_channels, stride)
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
)


def mobilenet(classes: int = 1000, input_shape=(224, 224, 3),
              alpha: float = 1.0, has_dropout: bool = True,
              bn_momentum: float = 0.99) -> Model:
    """``bn_momentum``: running-stat averaging window; lower it for short
    training runs (a ~0.99 window needs hundreds of steps to converge
    through this many stacked BNs)."""
    def c(ch):
        return max(int(ch * alpha), 8)

    inp = Input(shape=input_shape, name="input")
    x = Convolution2D(c(32), 3, 3, subsample=(2, 2), border_mode="same",
                      bias=False, name="conv1")(inp)
    x = BatchNormalization(momentum=bn_momentum, name="conv1_bn")(x)
    x = Activation("relu", name="conv1_relu")(x)
    for i, (ch, stride) in enumerate(_MOBILENET_PLAN, start=1):
        x = _dw_block(x, c(ch), stride, f"block{i}", bn_momentum)
    x = GlobalAveragePooling2D(name="pool")(x)
    if has_dropout:
        x = Dropout(0.001, name="dropout")(x)
    out = Dense(classes, activation="softmax", name="classifier")(x)
    return Model(inp, out, name="mobilenet")


# ---------------------------------------------------------------------------
# MobileNet v2 (reference mobilenet-v2 config; Sandler 2018 — inverted
# residuals with linear bottlenecks)
# ---------------------------------------------------------------------------

_MOBILENET_V2_PLAN = (  # (expansion, out_channels, repeats, first_stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
)


def _inverted_residual(x, in_ch, out_ch, stride, expansion, name,
                       bn_momentum=0.99):
    y = x
    hidden = in_ch * expansion
    if expansion != 1:
        y = Convolution2D(hidden, 1, 1, bias=False,
                          name=f"{name}/expand")(y)
        y = BatchNormalization(momentum=bn_momentum,
                               name=f"{name}/expand_bn")(y)
        y = Activation("relu6", name=f"{name}/expand_relu")(y)
    y = DepthwiseConvolution2D(3, 3, subsample=(stride, stride),
                               border_mode="same", bias=False,
                               name=f"{name}/dw")(y)
    y = BatchNormalization(momentum=bn_momentum, name=f"{name}/dw_bn")(y)
    y = Activation("relu6", name=f"{name}/dw_relu")(y)
    y = Convolution2D(out_ch, 1, 1, bias=False,
                      name=f"{name}/project")(y)   # linear bottleneck
    y = BatchNormalization(momentum=bn_momentum,
                           name=f"{name}/project_bn")(y)
    if stride == 1 and in_ch == out_ch:
        y = Merge(mode="sum", name=f"{name}/add")([x, y])
    return y


def mobilenet_v2(classes: int = 1000, input_shape=(224, 224, 3),
                 alpha: float = 1.0, bn_momentum: float = 0.99) -> Model:
    def c(ch):
        return max(int(ch * alpha), 8)

    inp = Input(shape=input_shape, name="input")
    x = Convolution2D(c(32), 3, 3, subsample=(2, 2), border_mode="same",
                      bias=False, name="conv1")(inp)
    x = BatchNormalization(momentum=bn_momentum, name="conv1_bn")(x)
    x = Activation("relu6", name="conv1_relu")(x)
    in_ch = c(32)
    for b, (t, ch, n, s) in enumerate(_MOBILENET_V2_PLAN, start=1):
        for i in range(n):
            stride = s if i == 0 else 1
            x = _inverted_residual(x, in_ch, c(ch), stride, t,
                                   f"block{b}_{i + 1}", bn_momentum)
            in_ch = c(ch)
    # canonical v2 rule: the last conv stays at 1280 unless alpha > 1
    last = c(1280) if alpha > 1.0 else 1280
    x = Convolution2D(last, 1, 1, bias=False, name="conv_last")(x)
    x = BatchNormalization(momentum=bn_momentum, name="conv_last_bn")(x)
    x = Activation("relu6", name="conv_last_relu")(x)
    x = GlobalAveragePooling2D(name="pool")(x)
    out = Dense(classes, activation="softmax", name="classifier")(x)
    return Model(inp, out, name="mobilenet_v2")
