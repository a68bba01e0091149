"""ImageClassifier — classification zoo model with config-driven
preprocessing (the port's own copy of
``analytics_zoo_tpu/models/image/imageclassification/classifier.py``;
every family ``build_model`` names is a port model).

Reference: imageclassification/ImageClassifier.scala:37 (``loadModel`` +
``predictImageSet`` with a per-model ``ImageConfigure``) and
ImageClassificationConfig.scala:31-188 (the registry mapping model names to
preprocess chains: resize 256 -> center crop 224 -> channel normalize with
imagenet mean/std) plus the ``LabelOutput`` postprocess attaching class
names + probabilities.
"""

from __future__ import annotations

import numpy as np

from analytics_zoo_tpu_torch.feature.image.imageset import ImageSet
from analytics_zoo_tpu_torch.feature.image.transforms import (
    ImageCenterCrop,
    ImageChannelNormalize,
    ImageResize,
)
from analytics_zoo_tpu_torch.models.common import ZooModel

IMAGENET_MEAN = (123.68, 116.779, 103.939)
IMAGENET_STD = (1.0, 1.0, 1.0)


class ImageClassificationConfig:
    """Preprocess chain + metadata for one model family (reference
    ImageConfigure)."""

    def __init__(self, resize: int = 256, crop: int = 224,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD, label_map=None):
        self.resize = resize
        self.crop = crop
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.label_map = label_map

    def preprocessing(self):
        from analytics_zoo_tpu_torch.feature.common import FnPreprocessing

        if len(self.mean) == 3:
            norm = ImageChannelNormalize(*self.mean, *self.std)
        else:  # grayscale / arbitrary channel count
            mean = np.asarray(self.mean, np.float32)
            std = np.asarray(self.std, np.float32)
            norm = FnPreprocessing(
                lambda img: (np.asarray(img, np.float32) - mean) / std)
        return (ImageResize(self.resize, self.resize)
                >> ImageCenterCrop(self.crop, self.crop)
                >> norm)


def ImagenetConfig(crop: int = 224) -> ImageClassificationConfig:
    """Reference ImagenetConfig (ImageClassificationConfig.scala:31-188)."""
    return ImageClassificationConfig(resize=256, crop=crop)


_CONFIGS = {
    "resnet-50": ImagenetConfig(224),
    "resnet-18": ImagenetConfig(224),
    # canonical input plans per family (reference ImageClassificationConfig
    # preprocess chains): alexnet 227, inception-v3 299
    "alexnet": ImageClassificationConfig(resize=256, crop=227),
    "inception-v3": ImageClassificationConfig(resize=320, crop=299),
    "lenet": ImageClassificationConfig(resize=28, crop=28, mean=(0,),
                                       std=(255.0,)),
}


def _config_for(model_name: str) -> ImageClassificationConfig:
    base = model_name.removesuffix("-quantize").removesuffix("-int8")
    return _CONFIGS.get(base, ImagenetConfig())


class LabelOutput:
    """Attach class names + sorted probabilities to raw predictions
    (reference LabelOutput.scala)."""

    def __init__(self, label_map=None, top_k: int = 5):
        self.label_map = label_map
        self.top_k = top_k

    def __call__(self, probs: np.ndarray):
        probs = np.asarray(probs)
        order = np.argsort(-probs, axis=-1)[..., :self.top_k]
        top_p = np.take_along_axis(probs, order, axis=-1)
        out = []
        for idx_row, p_row in zip(order, top_p):
            names = [
                self.label_map[int(i)] if self.label_map else int(i)
                for i in idx_row
            ]
            out.append(list(zip(names, p_row.tolist())))
        return out


class ImageClassifier(ZooModel):
    """Classification zoo model (reference ImageClassifier.scala:37).

    ``ImageClassifier(model_name)`` builds the named architecture with the
    matching preprocess config; ``ImageClassifier(model=net)`` wraps an
    existing KerasNet.
    """

    def __init__(self, model_name: str = "resnet-50", classes: int = 1000,
                 model=None, config: ImageClassificationConfig | None = None):
        self.model_name = model_name
        self.classes = classes
        self._provided = model
        self.config = config or _config_for(model_name)
        super().__init__()

    def build_model(self):
        if self._provided is not None:
            return self._provided
        # The reference's "<model>-quantize"/"-int8" variants
        # (ImageClassificationConfig.scala:31-50) are a deployment pass
        # here: build the same graph, then
        # InferenceModel.optimize("int8", ...) quantizes it.
        name = self.model_name
        for suffix in ("-quantize", "-int8"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        shape = (self.config.crop, self.config.crop, 3)
        if name.startswith("resnet"):
            from analytics_zoo_tpu_torch.models.resnet import ResNet

            depth = int(name.split("-")[1])
            return ResNet.image_net(depth, classes=self.classes,
                                    input_shape=shape)
        if name == "lenet":
            from analytics_zoo_tpu_torch.models.lenet import build_lenet

            return build_lenet(classes=self.classes)
        if name == "inception-v1":
            from analytics_zoo_tpu_torch.models.inception import Inception

            return Inception.v1(classes=self.classes, input_shape=shape)
        if name == "inception-v3":
            from analytics_zoo_tpu_torch.models.inception import inception_v3

            return inception_v3(classes=self.classes, input_shape=shape)
        from analytics_zoo_tpu_torch.models import imagenet_zoo as zoo_nets

        factories = {
            "alexnet": zoo_nets.alexnet,
            "vgg-16": lambda **kw: zoo_nets.vgg(16, **kw),
            "vgg-19": lambda **kw: zoo_nets.vgg(19, **kw),
            "densenet-121": lambda **kw: zoo_nets.densenet(121, **kw),
            "densenet-161": lambda **kw: zoo_nets.densenet(161, **kw),
            "squeezenet": zoo_nets.squeezenet,
            "mobilenet": zoo_nets.mobilenet,
            "mobilenet-v2": zoo_nets.mobilenet_v2,
        }
        if name in factories:
            return factories[name](classes=self.classes, input_shape=shape)
        raise ValueError(f"unknown model {self.model_name!r}")

    def predict_image_set(self, image_set: ImageSet, top_k: int = 5,
                          batch_size: int = 32):
        """Reference ``predictImageSet`` + LabelOutput: preprocess chain ->
        batched forward -> top-k (name, prob) per image."""
        transformed = image_set.transform(self.config.preprocessing())
        xs = transformed.to_feature_set().xs[0]
        probs = self.model.predict(xs, batch_size=batch_size)
        return LabelOutput(self.config.label_map, top_k)(probs)
