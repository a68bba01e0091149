"""Host data layer: FeatureSet, per-record preprocessing and the prefetch
plane."""
from analytics_zoo_tpu_torch.feature.common import (  # noqa: F401
    ChainedPreprocessing,
    Preprocessing,
)
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet  # noqa: F401
from analytics_zoo_tpu_torch.feature.prefetch import (  # noqa: F401
    PrefetchFeatureSet,
    PrefetchPipeline,
)
