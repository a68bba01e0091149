"""The port's data tiers against the reference's: the DRAM array set, the
PMEM tier (memory-mapped spool files) and the DISK_n tier (``.npz``
shards, a resident slice, the npz header sizer, the read-ahead), each
with the mid-epoch resume contract (``start_batch``).

Twins of ``tests/test_dataset.py``'s single-process tests, and the port's
batches held against the reference's, element for element (exact), for
array, sharded, spilled and resumed sets, shuffled and in order.
"""

import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature import dataset as jds
from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.feature.dataset import (
    ArrayFeatureSet,
    FeatureSet,
    ShardedFeatureSet,
)

SIZES = [17, 5, 23, 11, 3, 19]


@pytest.fixture(autouse=True)
def _restore():
    saved = engine._CONTEXT
    yield
    engine._CONTEXT = saved


@pytest.fixture
def shard_dir(tmp_path):
    """6 shards with uneven sizes (including tiny ones < batch_size)."""
    start = 0
    for i, n in enumerate(SIZES):
        x = np.arange(start, start + n, dtype=np.float32)[:, None] * [1.0, 2.0]
        y = np.arange(start, start + n, dtype=np.int32)
        np.savez(tmp_path / f"shard{i}.npz", x=x, y=y)
        start += n
    return str(tmp_path)


def _paths(shard_dir):
    return sorted(glob.glob(os.path.join(shard_dir, "*.npz")))


def _collect(fs, batch_size, **kw):
    kw.setdefault("shuffle", True)
    return list(fs.batches(batch_size, seed=5, epoch=2, **kw))


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            va, vb = a[k], b[k]
            if isinstance(vb, list):
                for p, q in zip(va, vb, strict=True):
                    np.testing.assert_array_equal(p, q)
                    assert p.dtype == q.dtype
            else:
                np.testing.assert_array_equal(va, vb)
                assert np.asarray(va).dtype == np.asarray(vb).dtype


def test_npz_header_sizer(shard_dir):
    fs = ShardedFeatureSet(_paths(shard_dir), n_slices=3)
    assert fs.num_samples == sum(SIZES)
    assert not fs._cache  # sizing read no array data
    assert fs.steps_per_epoch(8) == sum(SIZES) // 8
    assert fs.steps_per_epoch(8, drop_last=False) == -(-sum(SIZES) // 8)


def test_sharded_resume_matches_full_iteration(shard_dir):
    paths = _paths(shard_dir)
    full = _collect(ShardedFeatureSet(paths, n_slices=2), 8)
    for start in (1, 3, 5, len(full) - 1):
        tail = _collect(ShardedFeatureSet(paths, n_slices=2), 8,
                        start_batch=start)
        _assert_same_batches(tail, full[start:])


def test_sharded_resume_skips_shard_io(shard_dir):
    paths = _paths(shard_dir)
    loads = []

    def counting_loader(path):
        loads.append(path)
        data = np.load(path, allow_pickle=False)
        return {k: data[k] for k in data.files}

    fs = ShardedFeatureSet(paths, n_slices=2, loader=counting_loader)
    full = _collect(ShardedFeatureSet(paths, n_slices=2), 8)
    fs._shard_sizes()  # a custom loader without a sizer loads each once
    n_size_loads = len(loads)
    fs._cache.clear()
    loads.clear()
    tail = _collect(fs, 8, start_batch=len(full) - 1)
    assert len(tail) == 1
    assert 0 < len(loads) < len(paths), loads
    assert n_size_loads == len(paths)


def test_resident_slice_is_bounded(shard_dir):
    fs = ShardedFeatureSet(_paths(shard_dir), n_slices=3)
    seen = []
    for _ in fs.batches(8, seed=5, epoch=0):
        seen.append(len(fs._cache))
    assert max(seen) <= 2  # ceil(6 / 3)


def test_resume_past_end_yields_nothing(shard_dir):
    paths = _paths(shard_dir)
    n = len(_collect(ShardedFeatureSet(paths, n_slices=2), 8))
    assert _collect(ShardedFeatureSet(paths, n_slices=2), 8,
                    start_batch=n + 3) == []


def test_read_ahead_keeps_the_batches(shard_dir):
    """With a read-ahead pool (one shard, then three, ahead) the batches
    are those of a set without one."""
    paths = _paths(shard_dir)
    want = _collect(ShardedFeatureSet(paths, n_slices=2), 8)
    fs = ShardedFeatureSet(paths, n_slices=2)
    with ThreadPoolExecutor(1) as pool:
        fs.set_read_ahead(pool)
        _assert_same_batches(_collect(fs, 8), want)
        fs.set_read_ahead_count(3)
        _assert_same_batches(_collect(fs, 8, start_batch=2), want[2:])
        with pytest.raises(ValueError, match=">= 1"):
            fs.set_read_ahead_count(0)
        fs.set_read_ahead(None)
    assert fs._ra_ahead == 1 and fs._ra_pool is None


def test_npz_sizer_handles_v3_headers_and_falls_back(tmp_path):
    import unittest.mock as mock
    import zipfile

    arr = np.arange(42, dtype=np.float32)[:, None] * [1.0, 2.0]
    p3 = str(tmp_path / "v3.npz")
    with zipfile.ZipFile(p3, "w") as z:
        with z.open("x.npy", "w") as f:
            np.lib.format.write_array(f, arr, version=(3, 0))
    assert ShardedFeatureSet._npz_first_dim(p3) == 42
    pbad = str(tmp_path / "bad.npz")
    np.savez(pbad, x=arr)
    with mock.patch("numpy.lib.format.read_array_header_1_0",
                    side_effect=ValueError("bad header")):
        assert ShardedFeatureSet._npz_first_dim(pbad) == 42
    assert ShardedFeatureSet([p3], n_slices=1).num_samples == 42


def test_array_padding_and_n_valid():
    x = np.arange(22, dtype=np.float32)[:, None]
    y = np.arange(22, dtype=np.int32)
    full = list(ArrayFeatureSet(x, y).batches(
        8, shuffle=False, drop_last=False, pad_to_batch=4))
    assert len(full[-1]["x"]) == 8 and int(full[-1]["n_valid"]) == 6
    want = list(jds.ArrayFeatureSet(x, y).batches(
        8, shuffle=False, drop_last=False, pad_to_batch=4))
    _assert_same_batches(full, want)


class TestPmemTier:
    def test_spill_produces_memmaps_with_identical_batches(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(256, 12)).astype(np.float32)
        y = rng.integers(0, 3, size=(256,)).astype(np.int32)
        dram = FeatureSet.array(x, y)
        pmem = FeatureSet.array(x, y, memory_type="PMEM")
        assert isinstance(pmem.xs[0], np.memmap)
        assert not isinstance(dram.xs[0], np.memmap)
        _assert_same_batches(list(pmem.batches(32, seed=5, epoch=2)),
                             list(dram.batches(32, seed=5, epoch=2)))

    def test_resume_contract_survives_spill(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(128, 4)).astype(np.float32)
        fs = FeatureSet.array(x, memory_type="PMEM")
        full = list(fs.batches(16, seed=3, epoch=1))
        _assert_same_batches(
            list(fs.batches(16, seed=3, epoch=1, start_batch=4)), full[4:])

    def test_spool_dir_and_cleanup(self, tmp_path):
        fs = FeatureSet.array(np.zeros((4, 2), np.float32),
                              memory_type="PMEM", spool_dir=str(tmp_path))
        spool = fs._spool.name
        assert os.path.dirname(spool) == str(tmp_path)
        assert os.listdir(spool) == ["x0.npy"]
        fs._spool.cleanup()
        assert not os.path.exists(spool)

    def test_fit_through_pmem_tier(self):
        """The tier changes where bytes live, not a bit of training."""
        from analytics_zoo_tpu_torch import init_zoo_context
        from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

        torch.set_num_threads(1)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(256, 8)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.int32)
        out = {}
        for tier in ("DRAM", "PMEM"):
            init_zoo_context(seed=0, device="cpu")
            m = Sequential()
            m.add(Dense(16, activation="relu", input_shape=(8,)))
            m.add(Dense(2, activation="softmax"))
            m.compile(optimizer="adam",
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"])
            m.fit(FeatureSet.array(x, y, memory_type=tier), batch_size=32,
                  nb_epoch=30)
            out[tier] = (m._estimator.loss_log, m.evaluate(x, y))
        assert out["PMEM"] == out["DRAM"]
        assert out["PMEM"][1]["accuracy"] > 0.9


def _multi_input_shards(tmp_path, sizes):
    """Shards of a two-input set ([x0, x1], y, w) read by a loader."""
    start = 0
    paths = []
    for i, n in enumerate(sizes):
        rows = np.arange(start, start + n)
        p = str(tmp_path / f"m{i}.npz")
        np.savez(p, x0=rows[:, None].astype(np.float32) * [1.0, -1.0],
                 x1=(rows % 7).astype(np.int32), y=rows.astype(np.int32),
                 w=(rows / 10).astype(np.float32))
        paths.append(p)
        start += n
    return paths


def _loader(path):
    d = np.load(path)
    return {"x": [d["x0"], d["x1"]], "y": d["y"], "w": d["w"]}


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("start", [0, 1, 4, 9])
@pytest.mark.parametrize("kind", ["array", "pmem", "sharded", "sharded_multi"])
def test_batches_equal_the_reference(tmp_path, shard_dir, kind, start,
                                     shuffle):
    """The port's batches for (seed, epoch, start_batch) are the
    reference's, element for element."""
    rng = np.random.default_rng(2)
    if kind in ("array", "pmem"):
        x = [rng.normal(size=(70, 3)).astype(np.float32),
             rng.integers(0, 9, (70, 5)).astype(np.int32)]
        y = rng.integers(0, 2, 70).astype(np.int32)
        mt = "PMEM" if kind == "pmem" else "DRAM"
        port = FeatureSet.array(x, y, memory_type=mt)
        ref = jds.FeatureSet.array(x, y, memory_type=mt)
    elif kind == "sharded":
        port = FeatureSet.from_shards(_paths(shard_dir), "DISK_2")
        ref = jds.FeatureSet.from_shards(_paths(shard_dir), "DISK_2")
    else:
        paths = _multi_input_shards(tmp_path, [13, 4, 21, 9])
        port = FeatureSet.from_shards(paths, "DISK_4", loader=_loader)
        ref = jds.FeatureSet.from_shards(paths, "DISK_4", loader=_loader)
    assert port.num_samples == ref.num_samples
    for epoch in (0, 3):
        for drop_last in (True, False):
            kw = dict(seed=11, epoch=epoch, shuffle=shuffle,
                      drop_last=drop_last, start_batch=start)
            _assert_same_batches(list(port.batches(8, **kw)),
                                 list(ref.batches(8, **kw)))
