"""Host data layer: FeatureSet and per-record preprocessing."""
