"""The port's host data plane against the JAX package's: TFRecord reading
(``feature/tfrecord.py``), the dataset additions (``from_tfrecord``,
``transform_on_device``, ``prefetch``, the RAM accounting), the prefetch
pool (``feature/prefetch.py``), autotune (``feature/autotune.py``),
``imagenet_feature_set`` and the estimator's side: a device transform
inside the train and eval steps, the prefetch wrap, the dynamic-K chunker,
the ``infeed`` heartbeat and ``measure_pure_step``.

Tolerances: bytes and uint8 batches equal; streams byte-identical (by
digest) serial and prefetched, in both packages; autotuned trajectories
``==`` the K=1 ones; a fit with a device transform within the port's fit
tests' tolerances of the JAX package (losses 1e-5 relative, parameters
1e-4 of each leaf's largest magnitude: Adam, lr 1e-2, a few steps).  The
JAX package's CPU mesh has 8 devices, so its batches are multiples of 8.
"""

import hashlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.feature import autotune as jauto
from analytics_zoo_tpu.feature import prefetch as jpre
from analytics_zoo_tpu.feature import tfrecord as jtfr
from analytics_zoo_tpu.feature.dataset import FeatureSet as JSet

from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.feature import autotune as tauto
from analytics_zoo_tpu_torch.feature import prefetch as tpre
from analytics_zoo_tpu_torch.feature import tfrecord as ttfr
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet as TSet

SEED, BATCH = 13, 8
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _contexts():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init

    saved = (jax_engine._CONTEXT, torch_engine._CONTEXT,
             torch.get_num_threads())
    torch.set_num_threads(1)
    jax_init(seed=SEED)
    torch_init(seed=SEED, device="cpu")
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved[:2]
    torch.set_num_threads(saved[2])


def _digest(batches):
    h, n = hashlib.sha256(), 0
    for b in batches:
        for k in sorted(b):
            for a in (b[k] if isinstance(b[k], list) else [b[k]]):
                a = np.ascontiguousarray(a)
                h.update(f"{k}{a.dtype}{a.shape}".encode() + a.tobytes())
        n += 1
    return h.hexdigest(), n


def _shards(tmp_path, n=4, rows=10, shape=(6,), seed=0, name="s"):
    gen = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = tmp_path / f"{name}{i}.npz"
        np.savez(path, x=gen.integers(0, 256, (rows,) + shape,
                                      dtype=np.uint8),
                 y=gen.integers(0, 3, rows).astype(np.int32))
        paths.append(str(path))
    return paths


def _raw_records(tmp_path, n_files=3, per_file=5, side=6, seed=1):
    gen = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        path = str(tmp_path / f"r{i}.tfrecord")
        ttfr.write_tfrecord_file(path, [ttfr.encode_example({
            "image/raw": gen.integers(0, 256, (side, side, 3),
                                      dtype=np.uint8).tobytes(),
            "image/class/label": [int(gen.integers(0, 5))]})
            for _ in range(per_file)])
        paths.append(path)
    return paths


def _raw_parser(side=6):
    def parse(fm):
        return (np.frombuffer(fm["image/raw"][0], np.uint8).reshape(
            side, side, 3), np.int32(fm["image/class/label"][0]))
    return parse


# ---------------------------------------------------------------------------
# TFRecord
# ---------------------------------------------------------------------------
def test_tfrecord_bytes_and_examples_cross_the_packages(tmp_path):
    feats = {"b": b"\x00\xffbytes", "i": [3, -7, 1 << 40],
             "f": [0.5, -2.25], "a": np.arange(5, dtype=np.int64),
             "af": np.linspace(0, 1, 4, dtype=np.float32)}
    ex_t, ex_j = ttfr.encode_example(feats), jtfr.encode_example(feats)
    assert ex_t == ex_j
    assert ttfr.parse_example(ex_t) == jtfr.parse_example(ex_t)
    for writer, reader in ((ttfr, jtfr), (jtfr, ttfr)):
        path = str(tmp_path / f"{writer.__name__}.tfrecord")
        writer.write_tfrecord_file(path, [ex_t, b"", ex_j * 3])
        assert list(reader.read_tfrecord_file(path, verify_crc=True)) == \
            [ex_t, b"", ex_j * 3]
        assert reader.count_tfrecord_records(path) == \
            writer.count_tfrecord_records(path) == 3
        assert list(reader.read_tfrecord_file(path, chunk_size=7)) == \
            list(writer.read_tfrecord_file(path))


def test_tfrecord_corruption_raises_as_the_reference(tmp_path):
    path = tmp_path / "c.tfrecord"
    ttfr.write_tfrecord_file(str(path), [b"payload-one", b"payload-two"])
    data = bytearray(path.read_bytes())
    data[14] ^= 0xFF  # inside the first payload
    path.write_bytes(bytes(data))
    errors = []
    for mod in (ttfr, jtfr):
        with pytest.raises(ValueError) as e:
            list(mod.read_tfrecord_file(str(path), verify_crc=True))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "corrupt record payload" in errors[0]
    ttfr.write_tfrecord_file(str(path), [b"payload-one", b"payload-two"])
    path.write_bytes(path.read_bytes()[:-6])
    for mod in (ttfr, jtfr):
        assert len(list(mod.read_tfrecord_file(str(path)))) == 1
        with pytest.raises(ValueError, match="truncated"):
            list(mod.read_tfrecord_file(str(path), verify_crc=True))


def test_imagenet_example_parser_decodes_as_the_reference(tmp_path):
    import cv2

    gen = np.random.default_rng(2)
    imgs = [gen.integers(0, 256, (10 + i, 12, 3), dtype=np.uint8)
            for i in range(3)]
    recs = [ttfr.encode_example({
        "image/encoded": cv2.imencode(".png", im[:, :, ::-1])[1].tobytes(),
        "image/class/label": [i + 1]}) for i, im in enumerate(imgs)]
    for kw in ({}, {"image_size": 8, "label_offset": -1}):
        pt, pj = ttfr.imagenet_example_parser(**kw), \
            jtfr.imagenet_example_parser(**kw)
        for rec, im in zip(recs, imgs):
            (xt, yt), (xj, yj) = pt(ttfr.parse_example(rec)), \
                pj(jtfr.parse_example(rec))
            np.testing.assert_array_equal(xt, xj)
            assert yt == yj and yt.dtype == yj.dtype
            if not kw:
                np.testing.assert_array_equal(xt, im)


def test_from_tfrecord_stream_matches_the_reference(tmp_path):
    paths = _raw_records(tmp_path)
    tset = TSet.from_tfrecord(paths, _raw_parser(), "DISK_2")
    jset = JSet.from_tfrecord(paths, _raw_parser(), "DISK_2")
    assert tset.num_samples == jset.num_samples == 15
    for kw in (dict(epoch=1), dict(epoch=2, start_batch=2),
               dict(epoch=1, shuffle=False, drop_last=False)):
        want = _digest(jset.batches(4, seed=SEED, **kw))
        assert _digest(tset.batches(4, seed=SEED, **kw)) == want
        assert _digest(tset.prefetch(depth=3, workers=2).batches(
            4, seed=SEED, **kw)) == want


def test_imagenet_feature_set_reads_either_layout(tmp_path):
    from analytics_zoo_tpu.feature.imagenet import imagenet_feature_set as j
    from analytics_zoo_tpu_torch.feature.imagenet import (
        imagenet_feature_set as t,
    )

    os.makedirs(tmp_path / "npz")
    os.makedirs(tmp_path / "empty")
    _shards(tmp_path / "npz", shape=(4, 4, 3))
    got, want = t(str(tmp_path / "npz")), j(str(tmp_path / "npz"))
    assert _digest(got.batches(8, seed=SEED, epoch=1)) == \
        _digest(want.batches(8, seed=SEED, epoch=1))
    for fn in (t, j):
        with pytest.raises(FileNotFoundError, match="no TFRecord"):
            fn(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# the dataset additions
# ---------------------------------------------------------------------------
def test_device_transform_composes_and_forwards(tmp_path):
    x = np.arange(12, dtype=np.uint8).reshape(4, 3)
    sets = {"array": TSet.of(x), "pmem": TSet.array(x, memory_type="PMEM",
                                                    spool_dir=str(tmp_path)),
            "sharded": TSet.from_shards(_shards(tmp_path))}
    for name, fs in sets.items():
        assert fs.device_transform is None
        out = fs.transform_on_device(lambda b: {**b, "x": b["x"] + 1})
        assert out is fs
        fs.transform_on_device(lambda b: {**b, "x": b["x"] * 2})
        assert fs.device_transform({"x": 3}) == {"x": 8}, name
    base = TSet.of(x)
    wrapped = base.transform(lambda r: r)
    wrapped.transform_on_device(lambda b: "late")
    assert base.device_transform({}) == "late"
    pre = base.prefetch(depth=2, workers=1)
    assert isinstance(pre, tpre.PrefetchFeatureSet)
    assert pre.device_transform({}) == "late"
    pre.device_transform = None
    assert base.device_transform is None
    again = pre.transform(lambda r: r)
    assert isinstance(again, tpre.PrefetchFeatureSet)
    assert again.num_samples == 4


def test_ram_accounting_matches_the_reference(tmp_path):
    from analytics_zoo_tpu.feature.dataset import _host_nbytes as jn

    from analytics_zoo_tpu_torch.feature.dataset import _host_nbytes as tn

    batch = {"x": [np.zeros((3, 4), np.float32), np.zeros(5, np.uint8)],
             "y": np.zeros(3, np.int32), "n_valid": 3}
    assert tn(batch) == jn(batch) == 48 + 5 + 12
    assert tn([1]) == jn([1]) == 0
    paths = _shards(tmp_path, rows=7)
    t, j = TSet.from_shards(paths), JSet.from_shards(paths)
    assert t.last_shard_nbytes == j.last_shard_nbytes == 0
    next(t.batches(4, seed=1)), next(j.batches(4, seed=1))
    assert t.last_shard_nbytes == j.last_shard_nbytes == 7 * 6 + 7 * 4


# ---------------------------------------------------------------------------
# the prefetch pool
# ---------------------------------------------------------------------------
def _sets(pkg, tmp_path, kind):
    """One kind of set, built in ``pkg``'s package from the same shards."""
    import analytics_zoo_tpu.feature.image.transforms as jtf
    import analytics_zoo_tpu_torch.feature.image.transforms as ttf

    fs_cls, tf = (TSet, ttf) if pkg == "torch" else (JSet, jtf)
    paths = _shards(tmp_path, n=5, rows=9, shape=(10, 10, 1), seed=7)
    if kind == "array":
        data = np.load(paths[0])
        return fs_cls.of(data["x"], data["y"])
    fs = fs_cls.from_shards(paths, "DISK_2")
    if kind == "fused":
        fs = fs.transform(tf.ImageCenterCrop(8, 8)).transform(
            tf.ImageChannelScaledNormalizer(3, 3, 3, 0.5))
    elif kind == "random":
        tf._random_op_instances = 0
        fs = fs.transform(tf.ImageRandomCrop(6, 7) >> tf.ImageHFlip())
    return fs


PREFETCH_KINDS = {"array": 2, "sharded": 3, "fused": 4, "random": 1}


@pytest.mark.parametrize("kind", sorted(PREFETCH_KINDS))
def test_prefetched_streams_are_the_serial_ones_in_both_packages(tmp_path,
                                                                 kind):
    """Serial and prefetched, port and reference, whole epochs and a
    resume: one digest.  Random ops go through one worker (their counter
    draws race across workers, in both packages)."""
    workers = PREFETCH_KINDS[kind]
    digests = set()
    for pkg in ("torch", "jax"):
        for pooled in (False, True):
            fs = _sets(pkg, tmp_path, kind)
            if pooled:
                fs = fs.prefetch(depth=3, workers=workers)
            digests.add((_digest(fs.batches(4, seed=SEED, epoch=1)),
                         _digest(fs.batches(4, seed=SEED, epoch=2,
                                            start_batch=1))))
    assert len(digests) == 1


class _Boom(Exception):
    pass


def test_a_worker_error_surfaces_at_its_position(tmp_path):
    from analytics_zoo_tpu_torch.feature.common import FnPreprocessing

    calls = {"n": 0}

    def fail_third_batch(r):
        calls["n"] += 1
        if calls["n"] > 8:
            raise _Boom("record 9")
        return r

    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    fs = TSet.of(x).transform(FnPreprocessing(fail_third_batch))
    got = []
    with pytest.raises(_Boom, match="record 9"):
        for b in fs.prefetch(depth=2, workers=1).batches(
                4, shuffle=False):
            got.append(b["x"])
    assert len(got) == 2
    deadline = time.monotonic() + 5
    while any(t.name.startswith("zoo-prefetch") and t.is_alive()
              for t in threading.enumerate()):
        assert time.monotonic() < deadline, "prefetch threads left running"
        time.sleep(0.01)


def test_order_holds_under_many_workers_and_resizes():
    """More workers than cores, a short switch interval, and the pool and
    queue resized while batches flow: every batch arrives once, in source
    order (a lost or reordered delivery breaks the sequence)."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = 2 * (os.cpu_count() or 1) + 1

        def slow_copy(b):
            time.sleep(0.0005 * (b["i"] % 3))
            return {"i": b["i"], "x": b["x"].copy()}

        source = ({"i": i, "x": np.full(4, i)} for i in range(300))
        with tpre.PrefetchPipeline(source, map_fn=slow_copy,
                                   workers=workers, depth=8) as pipe:
            got = []
            for b in pipe:
                got.append(b["i"])
                assert (b["x"] == b["i"]).all()
                if len(got) in (50, 150):
                    pipe.resize(workers=2, depth=3)
                elif len(got) == 100:
                    pipe.resize(workers=workers, depth=16)
        assert got == list(range(300))
    finally:
        sys.setswitchinterval(interval)


def test_queue_and_pool_resize_online():
    q = tpre._ResizableQueue(1)
    q.put(1)
    with pytest.raises(tpre.queue.Full):
        q.put(2, timeout=0.01)
    q.resize(2)
    q.put(2, timeout=0.01)
    assert (q.get(), q.get_nowait(), q.qsize(), q.capacity) == (1, 2, 0, 2)
    with pytest.raises(ValueError):
        q.resize(0)
    pool = tpre._WorkerPool(1)
    assert [pool.submit(lambda i=i: i * i).result(2) for i in range(4)] == \
        [0, 1, 4, 9]
    pool.resize(3)
    assert pool.max_workers == 3
    pool.resize(1)
    assert pool.submit(lambda: 7).result(2) == 7
    pool.shutdown(wait=True)
    with pytest.raises(RuntimeError, match="after shutdown"):
        pool.submit(lambda: 0)


def test_pipeline_telemetry_matches_the_reference_families():
    """Both pipelines report the same ``zoo_data_prefetch_*`` families and
    counts, and beat ``data_prefetch`` in their own health registry while
    the producer runs (unregistered when it ends)."""
    from analytics_zoo_tpu.metrics import DataPipelineMetrics as JM
    from analytics_zoo_tpu.metrics import MetricsRegistry as JReg
    from analytics_zoo_tpu.metrics import get_health as jhealth
    from analytics_zoo_tpu.metrics import prometheus_text as jtext

    from analytics_zoo_tpu_torch.metrics import (
        DataPipelineMetrics,
        MetricsRegistry,
        get_health,
        prometheus_text,
    )

    def families(text):
        return sorted({line.split()[2] for line in text.splitlines()
                       if line.startswith("# TYPE")})

    reg, jreg = MetricsRegistry(enabled=True), JReg(enabled=True)
    for pipe_cls, m, health in (
            (tpre.PrefetchPipeline, DataPipelineMetrics(reg), get_health),
            (jpre.PrefetchPipeline, JM(jreg), jhealth)):
        seen = []

        def source():
            for i in range(5):
                seen.append("data_prefetch" in health().status()[
                    "components"])
                yield {"x": np.full(3, i, np.float32)}

        with pipe_cls(source(), map_fn=lambda b: b, workers=2, depth=2,
                      metrics=m) as pipe:
            out = [b["x"][0] for b in pipe]
        assert out == [0, 1, 2, 3, 4]
        assert m.batches.get() == 5 and m.batch_bytes.get() == 12
        assert seen == [True] * 5
        assert "data_prefetch" not in health().status()["components"]
    assert families(prometheus_text(reg)) == families(jtext(jreg))


def test_worth_prefetching_matches_the_reference(tmp_path):
    for kind in ("array", "sharded", "fused"):
        t, j = _sets("torch", tmp_path, kind), _sets("jax", tmp_path, kind)
        assert tpre.worth_prefetching(t) == jpre.worth_prefetching(j) \
            == (kind != "array")
    x = np.zeros((4, 2), np.float32)
    t = TSet.array(x, memory_type="PMEM", spool_dir=str(tmp_path))
    j = JSet.array(x, memory_type="PMEM", spool_dir=str(tmp_path))
    assert tpre.worth_prefetching(t) and jpre.worth_prefetching(j)
    assert not tpre.worth_prefetching(TSet.of(x).prefetch())


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------
def test_the_oracle_prior_is_refused_naming_item_19():
    from analytics_zoo_tpu_torch.common.engine import get_zoo_context

    with pytest.raises(NotImplementedError, match="item 19"):
        tauto.AutotuneController(oracle=object())
    cfg = get_zoo_context().config
    with pytest.raises(NotImplementedError, match="item 19"):
        tauto.AutotuneController.from_config(cfg, oracle=object())
    ctrl = tauto.AutotuneController.from_config(cfg)
    assert ctrl.current()["k"] == 1 and ctrl.interval == 0.25
    assert set(tauto.varz_doc()) == {"controllers", "decisions"}


def _decisions(ctrl):
    return [{k: d[k] for k in ("knob", "old", "new", "reason")}
            for d in ctrl.decision_log()]


def test_k_hill_climb_decides_as_the_reference(monkeypatch, tmp_path):
    """The same dispatch times into both controllers (the reference's
    without an oracle, as under ZOO_ORACLE=0): the same K decisions, the
    same state, and the same persisted tune log."""
    monkeypatch.setenv("ZOO_TUNE_LOG_DIR", str(tmp_path))
    per_step = {1: 1.0, 2: 0.6, 4: 0.5, 8: 0.49, 16: 0.7}
    ctrls = [tauto.AutotuneController(k_samples=3, k_warm_skip=2),
             jauto.AutotuneController(k_samples=3, k_warm_skip=2)]
    for ctrl in ctrls:
        for i in range(80):
            k = ctrl.current_k()
            ctrl.observe_dispatch(k, per_step[k] * k * (1 + 0.001 * i))
            if i == 40:
                ctrl.observe_dispatch(16, 9.9)  # a stale chunk: ignored
    (t, j) = ctrls
    assert _decisions(t) == _decisions(j)
    assert t.current() == j.current()
    assert t.k_settled and t.current_k() == 4
    logs = sorted(os.listdir(tmp_path))
    assert len(logs) == 1  # one process: one file, both packages' records
    recs = [json.loads(line) for line in open(tmp_path / logs[0])]
    for r in recs:
        r.pop("ts")
        r.pop("pid")
    half = len(recs) // 2
    assert recs[:half] == recs[half:]
    assert [r["type"] for r in recs[:half]][-1] == "settle"


class _FakePipe:
    def __init__(self, metrics, workers=1, depth=1):
        self.metrics, self.workers, self.depth = metrics, workers, depth

    def resize(self, workers=None, depth=None):
        self.workers = workers or self.workers
        self.depth = depth or self.depth


@pytest.mark.parametrize("budget", [1 << 30, 4000])
def test_data_plane_ticks_decide_as_the_reference(budget):
    """Consumer waits fed to both controllers' ticks: the same worker,
    depth and read-ahead decisions (and the RAM-budget shed)."""
    from analytics_zoo_tpu.metrics import DataPipelineMetrics as JM
    from analytics_zoo_tpu.metrics import MetricsRegistry as JReg

    from analytics_zoo_tpu_torch.metrics import (
        DataPipelineMetrics,
        MetricsRegistry,
    )

    class _Sharded:
        last_shard_nbytes = 500
        ahead = 1

        def set_read_ahead_count(self, n):
            self.ahead = n

    out = []
    for mod, m in ((tauto, DataPipelineMetrics(MetricsRegistry())),
                   (jauto, JM(JReg()))):
        ctrl = mod.AutotuneController(ram_budget=budget, min_window=2,
                                      max_workers=8)
        pipe, sharded = _FakePipe(m, depth=2), _Sharded()
        m.batch_bytes.set(100)
        with ctrl._lock:
            ctrl._pipe, ctrl._sharded = pipe, sharded
        for wait in (0.0, 0.01, 0.02, 0.03, 0.0, 0.05, 0.05, 0.05):
            m.consumer_wait.observe(wait)
            ctrl._tick()
        out.append((_decisions(ctrl), pipe.workers, pipe.depth,
                    sharded.ahead))
    assert out[0] == out[1]
    assert out[0][0], "no decision fired"


# ---------------------------------------------------------------------------
# the estimator's side
# ---------------------------------------------------------------------------
def _mlp(pkg):
    if pkg == "jax":
        from analytics_zoo_tpu.pipeline.api.keras import Sequential
        from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
        from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam
    else:
        from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
        from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
            Adam,
        )
    net = Sequential()
    net.add(Dense(16, activation="tanh", input_shape=(6,)))
    net.add(Dense(3))
    net.compile(optimizer=Adam(1e-2),
                loss="sparse_categorical_crossentropy_from_logits",
                metrics=["accuracy"])
    return net


def _twins():
    jnet, tnet = _mlp("jax"), _mlp("torch")
    jnet.build_params()
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    return jnet, tnet


def _torch_u8(b):
    return {**b, "x": b["x"].float() / 255.0}


def _jax_u8(b):
    return {**b, "x": b["x"].astype(jnp.float32) / 255.0}


def test_fit_and_evaluate_with_a_device_transform_match_jax(tmp_path):
    """uint8 shards normalized inside the train and eval steps: every
    step's loss, the parameters and the evaluation against the JAX
    package's."""
    paths = _shards(tmp_path, n=3, rows=8)
    jnet, tnet = _twins()
    jnet.set_tensorboard(str(tmp_path), "dp")
    jset = JSet.from_shards(paths, "DISK_2").transform_on_device(_jax_u8)
    tset = TSet.from_shards(paths, "DISK_2").transform_on_device(_torch_u8)
    jnet.fit(jset, batch_size=BATCH, nb_epoch=2)
    tnet.fit(tset, batch_size=BATCH, nb_epoch=2)
    want = {int(s): v for s, v, _ in
            jnet._estimator._writers[0].read_scalar("Loss")}
    got = dict(tnet._estimator.loss_log)
    assert sorted(got) == sorted(want) == list(range(1, 7))
    np.testing.assert_allclose([got[i] for i in sorted(got)],
                               [want[i] for i in sorted(want)],
                               rtol=LOSS_RTOL)
    for name, leaves in jnet.params.items():
        for key, w in leaves.items():
            w = np.asarray(w)
            assert np.abs(tnet.params[name][key].numpy() - w).max() <= \
                PARAM_TOL * np.abs(w).max(), (name, key)
    val_t = TSet.from_shards(paths[:2]).transform_on_device(_torch_u8)
    val_j = JSet.from_shards(paths[:2]).transform_on_device(_jax_u8)
    got = tnet._estimator.evaluate(val_t, batch_size=BATCH)
    want = jnet._estimator.evaluate(val_j, batch_size=BATCH)
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert got["accuracy"] == want["accuracy"]


def test_the_step_cache_keys_on_the_transform(tmp_path):
    """Another transform is another train and eval step, and the fit runs
    it (the losses move with it)."""
    paths = _shards(tmp_path, n=2, rows=8)
    _, tnet = _twins()
    first = TSet.from_shards(paths).transform_on_device(_torch_u8)
    tnet.fit(first, batch_size=BATCH, nb_epoch=1)
    tnet.evaluate(first, batch_size=BATCH)
    est = tnet._estimator
    second = TSet.from_shards(paths).transform_on_device(
        lambda b: {**b, "x": b["x"].float() / 25.0})
    before = dict(est.loss_log)
    tnet.fit(second, batch_size=BATCH, nb_epoch=1)
    est._evaluate_with(*tnet.build_params(), second, BATCH)
    keys = [k[2] for k in est._steps]
    for tf in (first.device_transform, second.device_transform):
        assert sum(k is tf for k in keys) == 2  # a train and an eval step
    after = dict(est.loss_log)
    assert set(after) == {1, 2, 3, 4} and after[1] == before[1]


def _fit_losses(paths, env=None, autotune=None, monkeypatch=None):
    from analytics_zoo_tpu_torch import init_zoo_context

    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    init_zoo_context(seed=SEED, device="cpu")
    _, tnet = _twins()
    fs = TSet.from_shards(paths, "DISK_2").transform(
        lambda r: r).transform_on_device(_torch_u8)
    tnet.fit(fs, batch_size=BATCH, nb_epoch=3, autotune=autotune)
    for k in env or {}:
        monkeypatch.delenv(k)
    return tnet._estimator.loss_log, tnet.params


def test_prefetch_and_autotune_fits_are_the_k1_fit_bit_for_bit(
        tmp_path, monkeypatch):
    """The port: serial, ``ZOO_PREFETCH_WORKERS=2`` and an autotuned fit
    whose K climbs (1, 2, 4): the same losses and parameters exactly."""
    paths = _shards(tmp_path, n=4, rows=16)
    want, params = _fit_losses(paths)
    got, p2 = _fit_losses(paths, {"ZOO_PREFETCH_WORKERS": "2"},
                          monkeypatch=monkeypatch)
    ctrl = tauto.AutotuneController(k_candidates=(1, 2, 4), k_warm_skip=1,
                                    k_samples=2, interval=0.01)
    tuned, p3 = _fit_losses(paths, autotune=ctrl)
    ctrl.stop()
    assert got == want and tuned == want
    assert any(d["knob"] == "k" for d in ctrl.decision_log())
    for p in (p2, p3):
        for name in params:
            for key in params[name]:
                assert torch.equal(p[name][key], params[name][key])


def test_the_reference_autotunes_to_its_k1_trajectory(tmp_path):
    """The same contract in the JAX package, with the same controller
    settings, so both packages are held to it."""
    paths = _shards(tmp_path, n=4, rows=16)
    runs = []
    for ctrl in (False, jauto.AutotuneController(
            k_candidates=(1, 2), k_warm_skip=1, k_samples=2)):
        jnet = _mlp("jax")
        jnet.set_tensorboard(str(tmp_path / str(bool(ctrl))), "k")
        fs = JSet.from_shards(paths, "DISK_2").transform_on_device(_jax_u8)
        jnet.fit(fs, batch_size=BATCH, nb_epoch=2, autotune=ctrl)
        runs.append([v for _, v, _ in
                     jnet._estimator._writers[0].read_scalar("Loss")])
        if ctrl:
            ctrl.stop()
            assert ctrl.current_k() == 2 or ctrl.k_settled
    assert runs[0] == runs[1]


def test_dynamic_chunks_group_as_the_reference():
    """The port's one chunker against both of the reference's: a constant
    K as ``_chunk_batches``, a moving one as ``_chunk_batches_dynamic``."""
    from analytics_zoo_tpu.pipeline.estimator.estimator import (
        _chunk_batches,
        _chunk_batches_dynamic,
    )

    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _chunks_dynamic,
    )

    for ks in ([1, 2, 2, 4, 1, 3, 3, 3], [4, 4, 4, 4], [1] * 9):
        def k_fn(seq=iter(ks * 10)):
            return next(seq)
        got = list(_chunks_dynamic(range(17), k_fn))

        def k_fn(seq=iter(ks * 10)):  # noqa: F811 (a fresh sequence)
            return next(seq)
        want = [[p] if kind == "single" else p
                for kind, p in _chunk_batches_dynamic(range(17), k_fn)]
        assert got == want
    for k in (1, 2, 3, 4, 16, 17, 20):
        got = list(_chunks_dynamic(range(17), lambda: k))
        want = [[p] if kind == "single" else p
                for kind, p in _chunk_batches(range(17), k)]
        assert got == want


def test_the_infeed_heartbeat_lives_as_long_as_the_feeder(tmp_path):
    from analytics_zoo_tpu_torch.metrics import get_health

    seen = []

    class Watched(TSet.__mro__[0]):
        def __init__(self, base):
            self.base = base

        @property
        def num_samples(self):
            return self.base.num_samples

        def batches(self, *a, **kw):
            for b in self.base.batches(*a, **kw):
                seen.append("infeed" in get_health().status()["components"])
                yield b

    x = np.random.default_rng(0).integers(0, 256, (24, 6), dtype=np.uint8)
    y = np.zeros(24, np.int32)
    _, tnet = _twins()
    tnet.fit(Watched(TSet.of(x, y)).transform_on_device(_torch_u8),
             batch_size=BATCH, nb_epoch=2)
    assert seen and all(seen)
    assert "infeed" not in get_health().status()["components"]


def test_measure_pure_step_leaves_the_model_alone():
    _, tnet = _twins()
    est = tnet._make_estimator()
    before = {k: {n: t.clone() for n, t in v.items()}
              for k, v in tnet.params.items()}
    batch = {"x": np.full((BATCH, 6), 200, np.uint8),
             "y": np.zeros(BATCH, np.int32)}
    s1 = est.measure_pure_step(batch, n_steps=3, device_transform=_torch_u8)
    warm = est.last_probe_warmup_seconds
    s2 = est.measure_pure_step(batch, n_steps=3, device_transform=_torch_u8)
    assert s1 > 0 and s2 > 0 and warm > 0
    assert est.last_probe_warmup_seconds == 0.0
    for k, v in before.items():
        for n, t in v.items():
            assert torch.equal(tnet.params[k][n], t)
    with pytest.raises(ValueError, match="n_steps"):
        est.measure_pure_step(batch, n_steps=0)


def test_the_knobs_wrap_the_train_set_as_the_reference(tmp_path,
                                                       monkeypatch):
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import ZooConfig

    paths = _shards(tmp_path)
    monkeypatch.setenv("ZOO_PREFETCH_WORKERS", "4")
    init_zoo_context(seed=SEED, device="cpu")
    _, tnet = _twins()
    est = tnet._make_estimator()
    fs, ctrl, own, attached = est._data_plane(TSet.from_shards(paths), None)
    assert isinstance(fs, tpre.PrefetchFeatureSet)
    assert (fs.workers, fs.depth, ctrl, own, attached) == (4, 4, None,
                                                           False, None)
    monkeypatch.delenv("ZOO_PREFETCH_WORKERS")
    monkeypatch.setenv("ZOO_AUTOTUNE", "1")
    init_zoo_context(seed=SEED, device="cpu")
    est = tnet._make_estimator()
    x = np.zeros((8, 6), np.float32)
    resident = TSet.of(x)
    fs, ctrl, own, _ = est._data_plane(resident, None)
    assert fs is resident and own  # nothing to hide: not wrapped
    assert isinstance(ctrl, tauto.AutotuneController)
    fs, ctrl, own, _ = est._data_plane(TSet.from_shards(paths), False)
    assert not isinstance(fs, tpre.PrefetchFeatureSet) and ctrl is None
    shared = tauto.AutotuneController()
    mine = resident.prefetch()
    fs, ctrl, own, attached = est._data_plane(mine, shared)
    assert fs is mine and ctrl is shared and not own and attached is mine
    assert mine._controller is shared
    monkeypatch.delenv("ZOO_AUTOTUNE")
    ctx = init_zoo_context(ZooConfig(prefetch_workers=4, autotune=True,
                                     autotune_interval=0.1), device="cpu")
    assert ctx.config.prefetch_workers == 4 and ctx.config.autotune
