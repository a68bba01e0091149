"""Keras-2-style API variant (counterpart of
``analytics_zoo_tpu/pipeline/api/keras2``).

Models and topology are the Keras-1 engine's; only the layer constructor
surface differs.
"""

from analytics_zoo_tpu_torch.pipeline.api.keras.topology import (  # noqa: F401
    Model,
    Sequential,
)
from analytics_zoo_tpu_torch.pipeline.api.keras2 import layers  # noqa: F401
