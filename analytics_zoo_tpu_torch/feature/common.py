"""Composable preprocessing — reference ``Preprocessing[A,B]`` with the
``->`` chaining operator (zoo/.../feature/common/Preprocessing.scala;
FeatureSet.scala:82-84 uses it to attach transformers to datasets).

The port's own copy of ``analytics_zoo_tpu/feature/common.py``, which
imports neither JAX nor torch; its classes are kept identical so both
packages transform records the same way.

Python can't overload ``->``, so chaining is ``a >> b`` (or
``ChainedPreprocessing([a, b])``).  Transformers are host-side, pure
per-record functions; anything per-batch and numeric belongs on the
device, inside the step.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable


class Preprocessing:
    """A per-record transform; subclass and implement ``transform``."""

    def transform(self, record: Any) -> Any:
        raise NotImplementedError

    def __call__(self, record: Any) -> Any:
        return self.transform(record)

    def apply_iter(self, records: Iterable) -> Iterable:
        for r in records:
            yield self.transform(r)

    def __rshift__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        """``a >> b`` ≡ reference ``a -> b`` (Preprocessing.scala)."""
        return ChainedPreprocessing([self, other])


class ChainedPreprocessing(Preprocessing):
    def __init__(self, stages: list[Preprocessing]):
        flat = []
        for s in stages:
            if isinstance(s, ChainedPreprocessing):
                flat.extend(s.stages)
            else:
                flat.append(s)
        self.stages = flat

    def transform(self, record):
        for s in self.stages:
            record = s.transform(record)
        return record


class FnPreprocessing(Preprocessing):
    def __init__(self, fn: Callable):
        self.fn = fn

    def transform(self, record):
        return self.fn(record)


class FeatureLabelPreprocessing(Preprocessing):
    """Applies separate transforms to (feature, label) pairs — reference
    feature/common FeatureLabelPreprocessing."""

    def __init__(self, feature_transform: Preprocessing,
                 label_transform: Preprocessing | None = None):
        self.feature_transform = feature_transform
        self.label_transform = label_transform

    def transform(self, record):
        x, y = record
        x = self.feature_transform.transform(x)
        if self.label_transform is not None:
            y = self.label_transform.transform(y)
        return x, y
