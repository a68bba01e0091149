"""FeatureSet — the dataset abstraction: the DRAM, PMEM and DISK tiers.

The port's own copy of ``analytics_zoo_tpu/feature/dataset.py`` (the
reference module imports no JAX), with its arithmetic: batches are numpy
arrays cut from a seeded ``(seed, epoch)`` permutation, so both packages
yield byte-identical batches in the same order, and any (epoch, batch
index) position is reproducible (``batches(..., start_batch=)``, the
mid-epoch resume contract).

- :class:`ArrayFeatureSet`, the DRAM tier (reference DRAMFeatureSet,
  FeatureSet.scala:411-421): arrays resident in host memory.
- The PMEM tier, ``FeatureSet.array(..., memory_type="PMEM")``:
  :meth:`ArrayFeatureSet.spill_to_mmap` rewrites the arrays as ``.npy``
  spool files and reads batches through the page cache (memory-mapped),
  the role persistent memory played beyond DRAM.
- :class:`ShardedFeatureSet`, the DISK_n tier (reference DiskFeatureSet,
  FeatureSet.scala:332-409): ``.npz`` shards (or anything a ``loader``
  reads), a sliding slice of ``ceil(shards / n)`` resident, the shard order
  and each shard's rows shuffled from the same ``(seed, epoch)`` stream,
  sized from the npz headers without reading the arrays, and a resume that
  skips the shards no emitted batch touches.  With a read-ahead pool
  (:meth:`ShardedFeatureSet.set_read_ahead`; the estimator's fit sets a
  one-thread pool) the next ``set_read_ahead_count`` shards load while
  the current one is consumed.

Also as in the reference: TFRecord shards (:meth:`FeatureSet.from_tfrecord`,
``feature/tfrecord.py``), a per-batch transform run on the device inside
the captured train and eval steps (:meth:`FeatureSet.transform_on_device`;
the host ships compact dtypes such as uint8 images), and the parallel
prefetch plane (:meth:`FeatureSet.prefetch`, ``feature/prefetch.py``).
Per-process sharding (``process_shard``) waits for the distribution slice
(ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing

# "DRAM" | "DISK_<n>" | "PMEM"
MemoryType = str


def _as_list(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


def _unwrap(xs):
    return xs[0] if xs is not None and len(xs) == 1 else xs


class FeatureSet:
    """Base: iterate shuffled minibatches with exact, resumable state."""

    # Optional per-batch fn, a dict of device tensors -> a dict of device
    # tensors, run ON THE DEVICE inside the captured train/eval step (see
    # Estimator): the host ships compact dtypes (uint8 images) and the
    # normalization or augmentation runs on the card, inside the step.
    device_transform: Callable | None = None

    # ------------------------------------------------------------------
    # constructors (mirror FeatureSet.rdd / .array factories)
    # ------------------------------------------------------------------
    @staticmethod
    def of(x, y=None, sample_weight=None) -> "FeatureSet":
        if isinstance(x, FeatureSet):
            return x
        return ArrayFeatureSet(x, y, sample_weight)

    @staticmethod
    def array(x, y=None, sample_weight=None,
              memory_type: MemoryType = "DRAM",
              spool_dir: str | None = None) -> "FeatureSet":
        """Reference ``FeatureSet.array`` (FeatureSet.scala:423-466):
        ``memory_type`` selects the tier, ``"PMEM"`` spills the arrays to
        memory-mapped spool files in ``spool_dir`` (default: the temporary
        directory; point it at a real disk when that is RAM-backed),
        ``"DRAM"`` keeps them resident."""
        fs = ArrayFeatureSet(x, y, sample_weight)
        if str(memory_type).upper() == "PMEM":
            fs.spill_to_mmap(spool_dir)
        return fs

    @staticmethod
    def from_shards(paths: Sequence[str], memory_type: MemoryType = "DISK_4",
                    loader: Callable | None = None) -> "FeatureSet":
        """File shards (``.npz`` with ``x`` and optionally ``y``, ``w``, or
        whatever ``loader(path) -> dict`` reads), ``DISK_n`` keeping
        ``1/n`` of them resident."""
        n_slices = 1
        if memory_type.upper().startswith("DISK_"):
            n_slices = int(memory_type.split("_")[1])
        return ShardedFeatureSet(list(paths), n_slices=n_slices,
                                 loader=loader)

    @staticmethod
    def from_tfrecord(paths: Sequence[str], parse_fn: Callable | None = None,
                      memory_type: MemoryType = "DISK_4") -> "FeatureSet":
        """TFRecord shards (reference ``TFDataset.from_tfrecord_file``,
        pyzoo .../net/tf_dataset.py:456-501; no tensorflow needed, see
        feature/tfrecord.py).  ``parse_fn(feature_map) -> (x, y)`` maps one
        decoded tf.train.Example to arrays; the default is the ImageNet
        JPEG + label layout (``imagenet_example_parser``, which needs
        cv2)."""
        from analytics_zoo_tpu_torch.feature.tfrecord import (
            count_tfrecord_records,
            imagenet_example_parser,
            tfrecord_loader,
        )

        parse = parse_fn or imagenet_example_parser()
        n_slices = 1
        if memory_type.upper().startswith("DISK_"):
            n_slices = int(memory_type.split("_")[1])
        return ShardedFeatureSet(
            list(paths), n_slices=n_slices, loader=tfrecord_loader(parse),
            sizer=count_tfrecord_records)

    # ------------------------------------------------------------------
    @property
    def num_samples(self) -> int:
        raise NotImplementedError

    def transform(self, preprocessing: Preprocessing) -> "FeatureSet":
        """Attach a per-record transform."""
        return TransformedFeatureSet(self, preprocessing)

    def transform_on_device(self, fn: Callable) -> "FeatureSet":
        """Attach a per-batch torch transform run on the device inside the
        captured train and eval steps (after any already attached)."""
        prev = self.device_transform
        if prev is None:
            self.device_transform = fn
        else:
            self.device_transform = lambda b, _p=prev, _f=fn: _f(_p(b))
        return self

    def prefetch(self, depth: int = 4, workers: int = 2) -> "FeatureSet":
        """The same stream through the parallel host data plane
        (feature/prefetch.py): shard loads, host transforms and batch
        assembly on ``workers`` pool threads behind a ``depth``-bounded
        queue, delivered in order — byte-identical to the serial path for
        the same seed, epoch and start batch."""
        from analytics_zoo_tpu_torch.feature.prefetch import (
            PrefetchFeatureSet,
        )
        return PrefetchFeatureSet(self, depth=depth, workers=workers)

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, epoch: int = 0, drop_last: bool = True,
                start_batch: int = 0,
                pad_to_batch: int | None = None) -> Iterator[dict]:
        """Yield dict batches {"x": ..., "y": ..., "w": ...}; one pass is
        one epoch, shuffled by a seeded permutation of (seed, epoch), from
        batch ``start_batch`` on (the batches before it are the ones an
        uninterrupted pass yields first)."""
        raise NotImplementedError

    def steps_per_epoch(self, batch_size: int, drop_last: bool = True) -> int:
        n = self.num_samples
        return n // batch_size if drop_last else -(-n // batch_size)


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


def _host_nbytes(d) -> int:
    """Host bytes of a dict of arrays / array lists (0 for other shapes):
    the one accounting for both batch and shard sizes that feeds the
    autotune RAM-budget estimate (feature/autotune.py)."""
    if not isinstance(d, dict):
        return 0
    return int(sum(
        getattr(a, "nbytes", 0)
        for v in d.values()
        for a in (v if isinstance(v, (list, tuple)) else (v,))))


class ArrayFeatureSet(FeatureSet):
    """DRAM tier: arrays resident in host memory (or memory-mapped after
    :meth:`spill_to_mmap`)."""

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

    def spill_to_mmap(self, spool_dir: str | None = None):
        """The PMEM tier: rewrite every array as an ``.npy`` spool file
        and reopen it memory-mapped read-only.  A batch's fancy indexing
        then touches only the pages it needs; the page cache is the fast
        tier and the OS reclaims it under pressure.  The spool directory
        is deleted with the set."""
        import tempfile

        self._spool = tempfile.TemporaryDirectory(
            prefix="zoo_pmem_", dir=spool_dir)

        def mm(arrs, tag):
            if arrs is None:
                return None
            out = []
            for i, a in enumerate(arrs):
                path = os.path.join(self._spool.name, f"{tag}{i}.npy")
                np.save(path, a)
                out.append(np.load(path, mmap_mode="r"))
            return out

        self.xs = mm(self.xs, "x")
        self.ys = mm(self.ys, "y")
        self.ws = mm(self.ws, "w")
        return self

    def batches(self, batch_size, shuffle=True, seed=0, epoch=0,
                drop_last=True, start_batch=0, pad_to_batch=None):
        n = self._n
        if shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([seed, epoch])
            ).permutation(n)
        else:
            order = np.arange(n)
        n_batches = n // batch_size if drop_last else -(-n // batch_size)
        for b in range(start_batch, n_batches):
            idx = order[b * batch_size:(b + 1) * batch_size]
            yield _batch_from_arrays(self.xs, self.ys, self.ws, idx,
                                     pad_to_batch)


class ShardedFeatureSet(FeatureSet):
    """Disk tier with a resident slice (reference DiskFeatureSet,
    FeatureSet.scala:332-409: at most ``ceil(len(paths) / n_slices)``
    shards resident, the rest on disk).

    ``paths`` are ``.npz`` files with arrays ``x`` (and optionally ``y``,
    ``w``), or anything a custom ``loader(path) -> dict`` understands;
    ``sizer(path)`` gives a shard's record count without loading it (the
    default format is sized from its npz header).
    """

    def __init__(self, paths: Sequence[str], n_slices: int = 4,
                 loader: Callable | None = None,
                 sizer: Callable | None = None):
        if not paths:
            raise ValueError("no shards given")
        self.paths = list(paths)
        self.n_slices = max(1, min(int(n_slices), len(self.paths)))
        self._default_format = loader is None
        self.loader = loader or self._default_loader
        self.sizer = sizer
        self._cache: dict[str, dict] = {}
        self._sizes: list[int] | None = None
        # shard read-ahead: with a pool set, batches() submits the loads
        # of the next ``_ra_ahead`` shards while one is consumed
        self._ra_pool = None
        self._ra_futures: dict[str, Any] = {}
        self._ra_ahead = 1
        # host bytes of the last loaded shard (the autotune RAM estimate:
        # each read-ahead slot holds about one shard)
        self._last_shard_nbytes = 0

    @staticmethod
    def _default_loader(path: str) -> dict:
        data = np.load(path, allow_pickle=False)
        return {k: data[k] for k in data.files}

    @staticmethod
    def _npz_first_dim(path: str) -> int:
        """The leading dim of ``x`` from the npz member's header: no array
        data is read.  npy header versions (1,0), (2,0) and (3,0); an
        unparseable header falls back to loading the member."""
        import zipfile

        from numpy.lib import format as npformat

        try:
            with zipfile.ZipFile(path) as z:
                with z.open("x.npy") as f:
                    version = npformat.read_magic(f)
                    if version == (1, 0):
                        shape, _, _ = npformat.read_array_header_1_0(f)
                    elif version == (2, 0):
                        shape, _, _ = npformat.read_array_header_2_0(f)
                    else:
                        shape, _, _ = npformat._read_array_header(
                            f, version)
                    return int(shape[0])
        except Exception:
            return len(np.load(path, allow_pickle=False)["x"])

    def _shard_sizes(self):
        if self._sizes is None:
            if self.sizer is not None:
                self._sizes = [int(self.sizer(p)) for p in self.paths]
            elif self._default_format:
                self._sizes = [self._npz_first_dim(p) for p in self.paths]
            else:
                # a custom loader without a sizer: sizes need one load each
                # (through the resident cache)
                self._sizes = [len(_as_list(self._load(p)["x"])[0])
                               for p in self.paths]
        return self._sizes

    def set_read_ahead(self, pool, ahead: int | None = None) -> None:
        """Enable (an executor) or disable (None) shard read-ahead: with a
        pool, up to ``ahead`` (default 1) not-yet-resident shards load in
        the background.  Disabling resets the count to 1 unless ``ahead``
        is given."""
        self._ra_pool = pool
        if ahead is not None:
            self.set_read_ahead_count(ahead)
        if pool is None:
            self._ra_futures = {}
            if ahead is None:
                self._ra_ahead = 1

    def set_read_ahead_count(self, ahead: int) -> None:
        """How many shards ahead of the cursor may load concurrently."""
        if ahead < 1:
            raise ValueError(f"read-ahead count must be >= 1, got {ahead}")
        self._ra_ahead = int(ahead)

    @property
    def last_shard_nbytes(self) -> int:
        """Host bytes of the most recently loaded shard (0 before any
        load): the autotune RAM-budget estimator's per-slot cost."""
        return self._last_shard_nbytes

    def _read_ahead(self, path):
        if self._ra_pool is None or path in self._cache \
                or path in self._ra_futures:
            return
        try:
            self._ra_futures[path] = self._ra_pool.submit(self.loader, path)
        except RuntimeError:
            pass  # pool shutting down: the load happens in _load

    def _load(self, path):
        if path not in self._cache:
            # keep at most ceil(len/n_slices) shards resident
            budget = -(-len(self.paths) // self.n_slices)
            while len(self._cache) >= max(budget, 1):
                self._cache.pop(next(iter(self._cache)))
            fut = self._ra_futures.pop(path, None)
            data = fut.result() if fut is not None else self.loader(path)
            self._cache[path] = data
            if isinstance(data, dict):
                self._last_shard_nbytes = _host_nbytes(data)
        return self._cache[path]

    @property
    def num_samples(self) -> int:
        return sum(self._shard_sizes())

    def batches(self, batch_size, shuffle=True, seed=0, epoch=0,
                drop_last=True, start_batch=0, pad_to_batch=None):
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        shard_order = (rng.permutation(len(self.paths)) if shuffle
                       else np.arange(len(self.paths)))

        def concat(a, b_):
            if isinstance(a, list):
                return [concat(x1, x2) for x1, x2 in zip(a, b_)]
            return np.concatenate([a, b_], axis=0)

        def blen(batch):
            v = batch["x"]
            return len(v[0]) if isinstance(v, list) else len(v)

        # Resume (start_batch > 0) loads only the shards that overlap
        # stream rows >= start_batch * batch_size: the others are skipped
        # arithmetically, their permutations drawn and discarded so the
        # RNG stream stays aligned, and their share of a partly assembled
        # batch tracked as a row count (``leftover`` as an int).
        stream_start = start_batch * batch_size
        sizes = self._shard_sizes() if start_batch > 0 else None
        b = 0
        cum = 0
        leftover = None  # None | dict (real rows) | int (virtual row count)
        for j, si in enumerate(shard_order):
            if sizes is not None and cum + sizes[si] <= stream_start:
                n = sizes[si]
                if shuffle:
                    rng.permutation(n)  # keep the RNG stream aligned
                cum += n
                b = cum // batch_size
                rem = cum % batch_size
                leftover = rem if rem else None
                continue
            data = self._load(self.paths[si])
            # overlap the next shards' loads with this one's consumption
            # (no-op without a read-ahead pool)
            for jn in range(j + 1, min(j + 1 + self._ra_ahead,
                                       len(shard_order))):
                self._read_ahead(self.paths[shard_order[jn]])
            xs = _as_list(data["x"])
            ys = _as_list(data.get("y"))
            ws = _as_list(data.get("w"))
            n = len(xs[0])
            cum += n
            order = rng.permutation(n) if shuffle else np.arange(n)
            pos = 0
            if isinstance(leftover, int):
                # rows completing a batch before start_batch: consumed
                # without materializing them
                need = batch_size - leftover
                assert need <= n, (need, n, b, start_batch)
                pos = need
                b += 1
                leftover = None
            elif leftover is not None:
                need = batch_size - blen(leftover)
                idx = order[:need]
                fresh = _batch_from_arrays(xs, ys, ws, idx)
                merged = {k: concat(leftover[k], fresh[k]) for k in leftover}
                pos = need
                if blen(merged) == batch_size:
                    if b >= start_batch:
                        yield merged
                    b += 1
                    leftover = None
                else:
                    leftover = merged
                    continue
            while pos + batch_size <= n:
                idx = order[pos:pos + batch_size]
                if b >= start_batch:
                    yield _batch_from_arrays(xs, ys, ws, idx)
                b += 1
                pos += batch_size
            if pos < n:
                leftover = _batch_from_arrays(xs, ys, ws, order[pos:])
        if isinstance(leftover, dict) and not drop_last:
            if pad_to_batch is not None:
                n_valid = blen(leftover)
                pad = (-n_valid) % pad_to_batch

                def pad_fn(v):
                    if isinstance(v, list):
                        return [pad_fn(a) for a in v]
                    return np.concatenate(
                        [v, np.repeat(v[-1:], pad, axis=0)], axis=0
                    ) if pad else v

                leftover = {k: pad_fn(v) for k, v in leftover.items()}
                leftover["n_valid"] = np.asarray(n_valid, np.int32)
            yield leftover


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

    @property
    def device_transform(self):
        """The base's, so a transform attached at either level (even after
        this wrapper was made) reaches the estimator."""
        return self.base.device_transform

    @device_transform.setter
    def device_transform(self, fn):
        self.base.device_transform = fn
