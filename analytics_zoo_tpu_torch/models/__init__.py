"""The model zoo: LeNet-5 and ResNet so far (ROADMAP queue 1, item 15)."""

from analytics_zoo_tpu_torch.models.lenet import build_lenet  # noqa: F401
from analytics_zoo_tpu_torch.models.resnet import ResNet  # noqa: F401
