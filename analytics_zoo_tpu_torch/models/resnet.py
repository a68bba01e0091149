"""ResNet: channels-last bottleneck and basic-block ResNets on the graph
``Model`` API, and the ImageNet training recipe.

Counterpart of ``analytics_zoo_tpu/models/resnet.py``, with the same
layer names, so the same parameter and state trees (``params_from_jax``
carries a JAX ResNet over unchanged).  ``ResNet.image_net`` builds depths
18 to 152 with the 7x7/s2 stem or the space-to-depth stem (block 2, then a
4x4/s1 conv on 12 channels); ``ResNet.cifar`` the 6n+2 CIFAR layout;
``ResNet.imagenet_optimizer`` the reference's recipe: SGD with momentum
0.9 and weight decay 1e-4, the learning rate scaled by batch / 256,
linear warmup, then 0.1 at epochs 30, 60 and 80.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Activation,
    BatchNormalization,
    Convolution2D,
    Dense,
    GlobalAveragePooling2D,
    MaxPooling2D,
    Merge,
    SpaceToDepth,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    SGD,
    warmup_epoch_decay,
)

_STAGES = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv_bn(x, filters, k, stride=1, name=None, activation=True):
    y = Convolution2D(filters, k, k, subsample=(stride, stride),
                      border_mode="same", bias=False, init="he_normal",
                      name=None if name is None else f"{name}_conv")(x)
    y = BatchNormalization(
        name=None if name is None else f"{name}_bn")(y)
    if activation:
        y = Activation("relu")(y)
    return y


def _bottleneck(x, filters, stride, project, name):
    y = _conv_bn(x, filters, 1, stride, name=f"{name}_a")
    y = _conv_bn(y, filters, 3, 1, name=f"{name}_b")
    y = _conv_bn(y, 4 * filters, 1, 1, name=f"{name}_c", activation=False)
    if project:
        shortcut = _conv_bn(x, 4 * filters, 1, stride,
                            name=f"{name}_proj", activation=False)
    else:
        shortcut = x
    out = Merge(mode="sum", name=f"{name}_add")([y, shortcut])
    return Activation("relu")(out)


def _basic(x, filters, stride, project, name):
    y = _conv_bn(x, filters, 3, stride, name=f"{name}_a")
    y = _conv_bn(y, filters, 3, 1, name=f"{name}_b", activation=False)
    if project:
        shortcut = _conv_bn(x, filters, 1, stride, name=f"{name}_proj",
                            activation=False)
    else:
        shortcut = x
    out = Merge(mode="sum", name=f"{name}_add")([y, shortcut])
    return Activation("relu")(out)


class ResNet:
    """Factory namespace."""

    @staticmethod
    def image_net(depth: int = 50, classes: int = 1000,
                  input_shape=(224, 224, 3), stem: str = "7x7") -> Model:
        """ImageNet-scale ResNet.  ``stem``: ``"7x7"``, the 7x7/s2 conv,
        or ``"space_to_depth"`` (block 2, then a 4x4/s1 conv on 12
        channels: a train-from-scratch variant, its SAME borders differ
        from the 7x7's).  The same network follows either."""
        kind, stages = _STAGES[depth]
        block = _bottleneck if kind == "bottleneck" else _basic
        inp = Input(shape=input_shape, name="input")
        if stem == "space_to_depth":
            x = SpaceToDepth(2, name="stem_s2d")(inp)
            x = _conv_bn(x, 64, 4, stride=1, name="stem")
        elif stem == "7x7":
            x = _conv_bn(inp, 64, 7, stride=2, name="stem")
        else:
            raise ValueError(
                f"stem must be '7x7' or 'space_to_depth', got {stem!r}")
        x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                         border_mode="same")(x)
        filters = 64
        for si, blocks in enumerate(stages):
            for bi in range(blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                # a bottleneck stage 0 projects 64 to 256; a basic-block
                # stage 0 keeps the identity shortcut (ResNet-18/34)
                project = (bi == 0 and (si > 0 or kind == "bottleneck"))
                x = block(x, filters, stride, project,
                          name=f"res{si + 2}{chr(97 + bi)}")
            filters *= 2
        x = GlobalAveragePooling2D()(x)
        out = Dense(classes, activation="softmax", name="fc")(x)
        return Model(inp, out, name=f"resnet{depth}")

    @staticmethod
    def cifar(depth: int = 20, classes: int = 10) -> Model:
        """CIFAR ResNet (6n+2 layers, basic blocks, 32x32x3 input)."""
        n = (depth - 2) // 6
        inp = Input(shape=(32, 32, 3), name="input")
        x = _conv_bn(inp, 16, 3, 1, name="stem")
        filters = 16
        for si in range(3):
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                x = _basic(x, filters, stride, project=(bi == 0 and si > 0),
                           name=f"res{si + 2}{chr(97 + bi)}")
            filters *= 2
        x = GlobalAveragePooling2D()(x)
        out = Dense(classes, activation="softmax", name="fc")(x)
        return Model(inp, out, name=f"resnet{depth}_cifar")

    @staticmethod
    def imagenet_optimizer(base_lr=0.1, batch_size=256, steps_per_epoch=5004,
                           warmup_epochs=5, momentum=0.9,
                           weight_decay=1e-4) -> SGD:
        """The ImageNet recipe: linear warmup over ``warmup_epochs``, then
        0.1 at epochs 30, 60 and 80; momentum 0.9; weight decay 1e-4
        added to every gradient."""
        sched = warmup_epoch_decay(
            warmup_steps=warmup_epochs * steps_per_epoch,
            steps_per_epoch=steps_per_epoch,
            boundaries_epochs=(30, 60, 80),
            decay=0.1,
        )
        return SGD(lr=base_lr * batch_size / 256.0, momentum=momentum,
                   weight_decay=weight_decay, schedule=sched)
