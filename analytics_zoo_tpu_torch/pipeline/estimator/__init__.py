"""The training loop."""

from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (  # noqa: F401
    Estimator,
)
from analytics_zoo_tpu_torch.pipeline.estimator.local import (  # noqa: F401
    LocalEstimator,
)
