"""Text data: ``TextSet`` and ranking relations."""

from analytics_zoo_tpu_torch.feature.text.textset import (  # noqa: F401
    Relation,
    TextFeature,
    TextSet,
    read_relations_csv,
    read_relations_parquet,
)
