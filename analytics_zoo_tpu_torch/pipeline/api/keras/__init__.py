"""Keras-1-style API."""

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (  # noqa: F401
    Input,
    Layer,
    Variable,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.topology import (  # noqa: F401
    KerasNet,
    Model,
    Sequential,
    merge,
)
