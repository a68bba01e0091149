"""FeatureSet — the dataset abstraction (in-memory subset).

The port's own copy of the parts of ``analytics_zoo_tpu/feature/dataset.py``
the training slice runs: :meth:`FeatureSet.of`, the in-memory
:class:`ArrayFeatureSet` and per-record transforms.  The reference module
imports no JAX, and this copy keeps its arithmetic: batches are numpy
arrays cut from a seeded ``(seed, epoch)`` permutation, so both packages
yield byte-identical batches in the same order, and any (epoch, batch
index) position is reproducible.  Resuming mid-epoch, the disk and
memory-mapped tiers and per-process sharding wait for their slices
(ROADMAP queue 1, items 5-6).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing


def _as_list(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


def _unwrap(xs):
    return xs[0] if xs is not None and len(xs) == 1 else xs


class FeatureSet:
    """Base: iterate shuffled minibatches in a reproducible order."""

    @staticmethod
    def of(x, y=None, sample_weight=None) -> "FeatureSet":
        if isinstance(x, FeatureSet):
            return x
        return ArrayFeatureSet(x, y, sample_weight)

    @property
    def num_samples(self) -> int:
        raise NotImplementedError

    def transform(self, preprocessing: Preprocessing) -> "FeatureSet":
        """Attach a per-record transform."""
        return TransformedFeatureSet(self, preprocessing)

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, epoch: int = 0, drop_last: bool = True,
                pad_to_batch: int | None = None) -> Iterator[dict]:
        """Yield dict batches {"x": ..., "y": ..., "w": ...}; one pass is one
        epoch, shuffled by a seeded permutation of (seed, epoch)."""
        raise NotImplementedError


def _batch_from_arrays(xs, ys, ws, idx, pad_to=None):
    n_valid = len(idx)
    if pad_to is not None and n_valid % pad_to != 0:
        # padding repeats the last row
        pad = pad_to - n_valid % pad_to
        idx = np.concatenate([idx, np.repeat(idx[-1:], pad, axis=0)])
    take = lambda arrs: _unwrap([a[idx] for a in arrs]) \
        if arrs is not None else None  # noqa: E731
    batch = {"x": take(xs)}
    if ys is not None:
        batch["y"] = take(ys)
    if ws is not None:
        batch["w"] = take(ws)
    if pad_to is not None:
        # padded rows are marked via n_valid so evaluation masks them out
        batch["n_valid"] = np.asarray(n_valid, np.int32)
    return batch


class ArrayFeatureSet(FeatureSet):
    """DRAM tier: arrays resident in host memory."""

    def __init__(self, x, y=None, sample_weight=None):
        self.xs = _as_list(x)
        self.ys = _as_list(y)
        self.ws = _as_list(sample_weight)
        n = len(self.xs[0])
        for a in self.xs + (self.ys or []) + (self.ws or []):
            if len(a) != n:
                raise ValueError("all arrays must share the leading dim")
        self._n = n

    @property
    def num_samples(self) -> int:
        return self._n

    def batches(self, batch_size, shuffle=True, seed=0, epoch=0,
                drop_last=True, pad_to_batch=None):
        n = self._n
        if shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([seed, epoch])
            ).permutation(n)
        else:
            order = np.arange(n)
        n_batches = n // batch_size if drop_last else -(-n // batch_size)
        for b in range(n_batches):
            idx = order[b * batch_size:(b + 1) * batch_size]
            yield _batch_from_arrays(self.xs, self.ys, self.ws, idx,
                                     pad_to_batch)


def _preprocess_batch(preprocessing: Preprocessing, batch: dict) -> dict:
    """Apply a per-record transform to one assembled batch."""
    xs = batch["x"]
    single = not isinstance(xs, list)
    records = xs if single else list(zip(*xs))
    out = [preprocessing(r) for r in records]
    batch = dict(batch)
    batch["x"] = np.stack(out) if single else [
        np.stack(col) for col in zip(*out)
    ]
    return batch


class TransformedFeatureSet(FeatureSet):
    """Per-record preprocessing applied at batch-assembly time."""

    def __init__(self, base: FeatureSet, preprocessing: Preprocessing):
        self.base = base
        self.preprocessing = preprocessing

    @property
    def num_samples(self):
        return self.base.num_samples

    def batches(self, *args, **kwargs):
        for batch in self.base.batches(*args, **kwargs):
            yield _preprocess_batch(self.preprocessing, batch)
