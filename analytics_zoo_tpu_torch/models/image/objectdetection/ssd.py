"""SSD detection graphs (counterpart of
``analytics_zoo_tpu/models/image/objectdetection/ssd.py``).

Reference: ssd/SSDGraph.scala:56 (SSD-VGG16 graph: VGG base through conv5_3,
dilated fc6/fc7, extra feature layers conv8-11, per-map loc/conf heads,
conv4_3 L2 normalization with learnable scale) and ssd/SSD.scala:55-78
(per-map anchor params).

The whole detector is one graph ``Model`` (one captured CUDA graph a
train step or request bucket) — per-map heads are reshaped to
(B, k·fm², ·) and concatenated so the output is a dense (B, P, 4 + C+1)
tensor (loc offsets ++ class logits); no per-layer PriorBox modules
(priors are static numpy, see priors.py).  Activations are NHWC and
kernels HWIO, the reference's tree, so ``convert.params_from_jax``
carries its weights across; the conv layers take cuDNN on the
channels-first view.
"""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.models.image.objectdetection.priors import (
    PriorSpec,
    SSD300_SPECS,
    generate_priors,
)
from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    AtrousConvolution2D,
    Convolution2D,
    MaxPooling2D,
    Merge,
    Reshape,
)


class L2Normalize2D(Layer):
    """Channel-wise L2 normalization with learnable per-channel scale
    (reference NormalizeScale on conv4_3 in SSDGraph.scala; init 20)."""

    def __init__(self, scale_init=20.0, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.scale_init = float(scale_init)
        self._config = dict(scale_init=self.scale_init)

    def build(self, input_shape):
        self.add_weight("scale", (int(input_shape[-1]),),
                        init=self.scale_init)

    def call(self, params, inputs, state=None, training=False, rng=None):
        norm = torch.sqrt(
            torch.sum(inputs * inputs, dim=-1, keepdim=True) + 1e-10)
        return inputs / norm * params["scale"]


def _conv_relu(x, filters, k, stride=1, pad="same", name=None, dilation=1):
    if dilation > 1:
        return AtrousConvolution2D(
            filters, k, k, atrous_rate=(dilation, dilation),
            border_mode=pad, activation="relu", name=name)(x)
    return Convolution2D(filters, k, k, subsample=(stride, stride),
                         border_mode=pad, activation="relu", name=name)(x)


def _vgg_base(x):
    """VGG16 through conv5_3 + dilated fc6/fc7; returns (conv4_3, fc7)."""
    for i, (n, reps) in enumerate([(64, 2), (128, 2), (256, 3)]):
        for j in range(reps):
            x = _conv_relu(x, n, 3, name=f"conv{i + 1}_{j + 1}")
        # pool3 uses SAME so 75 -> 38 (the reference's ceil-mode pooling)
        x = MaxPooling2D(pool_size=(2, 2),
                         border_mode="same" if i == 2 else "valid",
                         name=f"pool{i + 1}")(x)
    for j in range(3):
        x = _conv_relu(x, 512, 3, name=f"conv4_{j + 1}")
    conv4_3 = x
    x = MaxPooling2D(pool_size=(2, 2), name="pool4")(x)
    for j in range(3):
        x = _conv_relu(x, 512, 3, name=f"conv5_{j + 1}")
    x = MaxPooling2D(pool_size=(3, 3), strides=(1, 1), border_mode="same",
                     name="pool5")(x)
    x = _conv_relu(x, 1024, 3, dilation=6, name="fc6")
    fc7 = _conv_relu(x, 1024, 1, name="fc7")
    return conv4_3, fc7


def _extra_layers(x):
    """conv8-11 feature pyramids; returns the 4 extra maps."""
    maps = []
    x = _conv_relu(x, 256, 1, name="conv8_1")
    x = _conv_relu(x, 512, 3, stride=2, name="conv8_2")
    maps.append(x)                                     # 10x10
    x = _conv_relu(x, 128, 1, name="conv9_1")
    x = _conv_relu(x, 256, 3, stride=2, name="conv9_2")
    maps.append(x)                                     # 5x5
    x = _conv_relu(x, 128, 1, name="conv10_1")
    x = _conv_relu(x, 256, 3, pad="valid", name="conv10_2")
    maps.append(x)                                     # 3x3
    x = _conv_relu(x, 128, 1, name="conv11_1")
    x = _conv_relu(x, 256, 3, pad="valid", name="conv11_2")
    maps.append(x)                                     # 1x1
    return maps


def _detection_heads(feature_maps, specs, n_classes):
    """Per-map loc/conf 3x3 convs -> concat (B, P, 4 + C+1)."""
    locs, confs = [], []
    for i, (fm, spec) in enumerate(zip(feature_maps, specs)):
        k = spec.boxes_per_loc
        loc = Convolution2D(k * 4, 3, 3, border_mode="same",
                            name=f"loc_{i}")(fm)
        conf = Convolution2D(k * (n_classes + 1), 3, 3, border_mode="same",
                             name=f"conf_{i}")(fm)
        locs.append(Reshape((-1, 4), name=f"loc_flat_{i}")(loc))
        confs.append(
            Reshape((-1, n_classes + 1), name=f"conf_flat_{i}")(conf))
    loc_all = Merge(mode="concat", concat_axis=1, name="loc_concat")(locs)
    conf_all = Merge(mode="concat", concat_axis=1,
                     name="conf_concat")(confs)
    return Merge(mode="concat", concat_axis=-1,
                 name="predictions")([loc_all, conf_all])


def ssd_vgg300(n_classes: int = 20, input_shape=(300, 300, 3)):
    """Full SSD-300 VGG16 (reference SSDVGG graph).

    Returns (Model, priors (8732, 4) center-size numpy)."""
    inp = Input(shape=input_shape, name="image")
    conv4_3, fc7 = _vgg_base(inp)
    conv4_3 = L2Normalize2D(name="conv4_3_norm")(conv4_3)
    maps = [conv4_3, fc7] + _extra_layers(fc7)
    out = _detection_heads(maps, SSD300_SPECS, n_classes)
    return Model(inp, out), generate_priors(SSD300_SPECS)


def ssd_tiny(n_classes: int = 3, input_shape=(64, 64, 3)):
    """Small SSD for tests/toy data: 3 conv stages, 2 feature maps
    (8x8, 4x4).  Same head/loss/postprocess contract as ssd_vgg300."""
    specs = [
        PriorSpec(8, 0.15, 0.3, (2.0,)),
        PriorSpec(4, 0.3, 0.6, (2.0,)),
    ]
    inp = Input(shape=input_shape, name="image")
    x = _conv_relu(inp, 16, 3, name="t_conv1")
    x = MaxPooling2D()(x)                               # 32
    x = _conv_relu(x, 32, 3, name="t_conv2")
    x = MaxPooling2D()(x)                               # 16
    x = _conv_relu(x, 64, 3, name="t_conv3")
    x = MaxPooling2D()(x)                               # 8
    fm1 = _conv_relu(x, 64, 3, name="t_conv4")
    fm2 = _conv_relu(MaxPooling2D()(fm1), 64, 3, name="t_conv5")  # 4
    out = _detection_heads([fm1, fm2], specs, n_classes)
    return Model(inp, out), generate_priors(specs)
