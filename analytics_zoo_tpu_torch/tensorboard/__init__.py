"""TensorBoard event files without tensorflow (``FileWriter`` and the
summaries)."""

from analytics_zoo_tpu_torch.tensorboard.writer import (  # noqa: F401
    FileWriter,
    InferenceSummary,
    TrainSummary,
    ValidationSummary,
)
