"""The model zoo: LeNet-5, ResNet, Inception-v1/v3 and the rest of the
ImageNet classification set (``imagenet_zoo``: AlexNet, VGG, SqueezeNet,
DenseNet, MobileNet and MobileNet-v2).  The recommendation, text and
detection models wait for their slice (ROADMAP queue 1, item 15)."""

from analytics_zoo_tpu_torch.models import imagenet_zoo  # noqa: F401
from analytics_zoo_tpu_torch.models.inception import (  # noqa: F401
    Inception,
    inception_v3,
)
from analytics_zoo_tpu_torch.models.lenet import build_lenet  # noqa: F401
from analytics_zoo_tpu_torch.models.resnet import ResNet  # noqa: F401
