"""The port's Cluster Serving against the JAX package's, on the CPU.

- Brokers: the same operations on ``InMemoryBroker`` and ``FileBroker``
  of either package give the same fields in the same order (claims,
  lease expiry and takeover, release, ack, trim, hashes,
  ``memory_ratio``); record ids, which carry a clock, are compared by
  the order they were added in.
- Client: ``encode_ndarray`` of one package and ``decode_ndarray`` of the
  other round-trip bit for bit; an admission verdict of "shed" refuses an
  enqueue alike.
- ``ClusterServingHelper`` and ``ModelSpec`` parse their overrides, yaml
  and env knobs the same way and raise the same errors; the
  continuous batcher flushes the same buckets.
- End to end: a small classifier built in the JAX package and carried
  over by ``params_from_jax`` is served by both packages'
  ``ClusterServing`` in the serial, pipelined and claim modes: every
  record is answered once with the same top-2 classes, the probabilities
  within 1e-5 (the two frameworks sum in different orders), and a
  mis-shaped record is dropped alike.

The ``cuda`` tests serve a small BERT over token ids in every mode on the
card and hold each answer against direct ``InferenceModel.predict`` (the
same bucket: bit for bit).  The JAX package is imported inside the tests
that compare with it, so the ``cuda`` ones run without it.
"""

import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

PACKAGES = ("analytics_zoo_tpu", "analytics_zoo_tpu_torch")
E2E_TOL = 1e-5


def _s(pkg, sub):
    return importlib.import_module(f"{pkg}.serving.{sub}")


# ---------------------------------------------------------------------------
# brokers
# ---------------------------------------------------------------------------
class _Clock:
    """Stands in for a broker module's ``time``: leases expire when the
    test advances it, never because the machine was slow (ids still come
    from the real ``time_ns``)."""

    time_ns = staticmethod(time.time_ns)

    def __init__(self):
        self.now = 1_000.0

    def monotonic(self):
        return self.now

    def time(self):
        return 1.7e9 + self.now

    def sleep(self, s):
        self.now += s


def _broker_ops(db, clock):
    """One sequence of stream, claim and hash operations; the record ids
    in what it returns are replaced by the order they were added in."""
    order = {}

    def add(fields):
        rid = db.xadd("s", fields)
        order[rid] = len(order)
        return rid

    def recs(rs):
        return [(order[r], f) for r, f in rs]

    out = []
    ids = [add({"uri": f"u{i}", "image": f"payload-{i}"}) for i in range(6)]
    out.append(("xread", recs(db.xread("s", 2, last_id="0"))))
    out.append(("xread after", recs(db.xread("s", 10, last_id=ids[3]))))
    out.append(("xlen", db.xlen("s")))
    a = db.claim("s", "A", 3, lease_ms=150)
    out.append(("claim A", recs(a)))
    out.append(("unclaimed", db.unclaimed("s")))
    b = db.claim("s", "B", 10, lease_ms=150)
    out.append(("claim B", recs(b)))
    out.append(("claim none", recs(db.claim("s", "C", 5, lease_ms=150))))
    db.extend("s", "A", [r for r, _ in a], 150)
    db.release("s", "B", [b[0][0]], done=True)
    db.release("s", "B", [r for r, _ in b[1:]], done=False)
    db.release("s", "A", [b[1][0]], done=True)  # not A's: skipped
    out.append(("after release", db.xlen("s"), db.unclaimed("s")))
    out.append(("takeovers before", db.pop_takeovers("C")))
    clock.sleep(0.4)  # A's leases expire
    c = db.claim("s", "C", 10, lease_ms=150)
    out.append(("claim C", recs(c)))
    out.append(("takeovers", db.pop_takeovers("C"), db.pop_takeovers("C")))
    db.release("s", "C", [r for r, _ in c], done=True)
    out.append(("drained", db.xlen("s"), db.unclaimed("s")))
    more = [add({"uri": f"v{i}", "image": "x" * (i + 1)}) for i in range(5)]
    db.xtrim("s", 3)
    out.append(("trim", db.xlen("s"), recs(db.xread("s", 10))))
    db.ack("s", more[3])
    out.append(("ack", db.xlen("s"), recs(db.xread("s", 10))))
    db.hset("result:a", {"uri": "a", "value": "[1]"})
    db.hset_many([("result:b", {"uri": "b", "value": "[2]"}),
                  ("result:c/d", {"uri": "c/d", "tensor": "AAAA"}),
                  ("other:x", {"uri": "x"})])
    out.append(("hashes", db.hgetall("result:b"), db.hgetall("result:c/d"),
                db.hgetall("missing")))
    out.append(("keys", sorted(db.keys("result:"))))
    db.delete("result:a")
    out.append(("keys after delete", sorted(db.keys("result:"))))
    out.append(("memory_ratio", round(db.memory_ratio(), 12)))
    db.close()
    return out


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_brokers_match_the_reference(kind, tmp_path, monkeypatch):
    def run(pkg):
        mod = _s(pkg, "broker")
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        db = mod.InMemoryBroker(max_records=40) if kind == "memory" \
            else mod.FileBroker(str(tmp_path / pkg), max_bytes=1 << 16)
        return _broker_ops(db, clock)

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref
    assert dict((r[0], r[1:]) for r in ref)["takeovers"] == (3, 0)


def test_connect_broker_specs_match(tmp_path):
    out = []
    for pkg in PACKAGES:
        mod = _s(pkg, "broker")
        kinds = [type(mod.connect_broker(s)).__name__
                 for s in (None, "memory", f"dir:{tmp_path}/a",
                           str(tmp_path / "b"))]
        mem = mod.InMemoryBroker()
        kinds.append(mod.connect_broker(mem) is mem)
        out.append(kinds)
    assert out[1] == out[0]


def test_redis_broker_needs_redis_alike():
    import importlib.util

    if importlib.util.find_spec("redis") is not None:
        pytest.skip("redis is installed here")
    errs = []
    for pkg in PACKAGES:
        with pytest.raises(ImportError) as e:
            _s(pkg, "broker").RedisBroker("localhost", 1)
        errs.append(str(e.value))
    assert errs[1] == errs[0]


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
ARRAYS = [np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
          np.array([[1, -2], [3, 2 ** 31 - 1]], np.int32),
          np.linspace(-3, 3, 9).astype(np.float16),
          np.array([True, False, True]),
          np.zeros((0, 5), np.uint8),
          np.array(np.nan, np.float64),
          np.random.default_rng(0).standard_normal((2, 3, 4))
          .astype(np.float32).transpose(2, 0, 1)]


@pytest.mark.parametrize("i", range(len(ARRAYS)))
def test_ndarray_codec_round_trips_across_packages(i):
    ref, port = _s(PACKAGES[0], "client"), _s(PACKAGES[1], "client")
    a = ARRAYS[i]
    assert port.encode_ndarray(a) == ref.encode_ndarray(a)
    for enc, dec in ((ref, port), (port, ref)):
        b = dec.decode_ndarray(enc.encode_ndarray(a))
        assert b.dtype == a.dtype and b.shape == a.shape
        assert a.tobytes() == np.ascontiguousarray(b).tobytes()


def test_client_queues_and_admission_match():
    out = []
    for pkg in PACKAGES:
        br, cl = _s(pkg, "broker"), _s(pkg, "client")
        db = br.InMemoryBroker()
        iq = cl.InputQueue(broker=db)
        oq = cl.OutputQueue(broker=db)
        iq.enqueue("a", np.ones(3, np.float32))
        routed = cl.InputQueue(broker=db, model="bert")
        routed.enqueue("b", np.zeros(2, np.int32))
        db.hset(cl.ADMISSION_KEY_PREFIX + routed.stream,
                {"state": "shed", "retry_after_ms": "250",
                 "reason": "backlog"})
        with pytest.raises(cl.ServingRejected) as e:
            routed.enqueue("c", np.zeros(2, np.int32))
        db.hset(cl.RESULT_PREFIX + "a",
                {"uri": "a", "value": json.dumps([[1, 0.5]])})
        db.hset(cl.RESULT_PREFIX + "t",
                {"uri": "t", "tensor": cl.encode_ndarray(np.eye(2))})
        with pytest.raises(cl.ServingTimeout) as t:
            oq.poll("never", timeout=0.01)
        got = oq.dequeue()
        out.append((iq.stream, routed.stream, iq.backlog(), routed.backlog(),
                    str(e.value), e.value.retry_after_s, e.value.reason,
                    oq.query("a"), got["a"], got["t"].tolist(),
                    type(t.value).__mro__[1].__name__, t.value.uri,
                    cl.model_stream("m")))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# helper, model specs, continuous batching
# ---------------------------------------------------------------------------
HELPER_CASES = [
    dict(model_path="/m", batch_size=16, top_n=3, data_shape="3,224,224",
         broker="memory", log_dir="/tmp/x"),
    dict(filter="topN(5)"),
    dict(batch_budget_ms=0, lease_ms=100),
    dict(batch_budget_ms=-1),
    dict(lease_ms=99),
]
ENV_CASES = [
    {"ZOO_SERVING_BATCH_BUDGET_MS": "12.5", "ZOO_FLEET_LEASE_MS": "250"},
    {"ZOO_SERVING_BATCH_BUDGET_MS": "fast"},
    {"ZOO_FLEET_LEASE_MS": "50"},
    {"ZOO_SERVING_BATCH_BUDGET_MS": "-1"},
]
HELPER_FIELDS = ("model_path", "batch_size", "top_n", "data_shape",
                 "broker_spec", "log_dir", "filter", "batch_budget_ms",
                 "lease_ms")


def _helper(pkg, config_path=None, **kw):
    try:
        h = _s(pkg, "server").ClusterServingHelper(config_path, **kw)
    except Exception as e:  # noqa: BLE001 - the error is the result
        return type(e).__name__, str(e)
    return {f: getattr(h, f) for f in HELPER_FIELDS}


@pytest.mark.parametrize("case", range(len(HELPER_CASES)))
def test_helper_overrides_match(case):
    ref, port = [_helper(p, **HELPER_CASES[case]) for p in PACKAGES]
    assert port == ref


@pytest.mark.parametrize("case", range(len(ENV_CASES)))
def test_helper_env_knobs_match(case, monkeypatch):
    for k, v in ENV_CASES[case].items():
        monkeypatch.setenv(k, v)
    ref, port = [_helper(p) for p in PACKAGES]
    assert port == ref
    # an explicit override beats the env
    ref, port = [_helper(p, batch_budget_ms=3, lease_ms=400)
                 for p in PACKAGES]
    assert port == ref


def test_helper_yaml_matches(tmp_path):
    cfg = tmp_path / "config.yaml"
    cfg.write_text("model:\n  path: /models/resnet\n"
                   "params:\n  batch_size: 32\n  top_n: 2\n"
                   "  filter: topN(4)\n  batch_budget_ms: 7\n"
                   "  lease_ms: 2000\n"
                   "data:\n  image_shape: 224,224,3\n  src: dir:/spool\n"
                   "log_dir: /logs\n")
    ref, port = [_helper(p, str(cfg)) for p in PACKAGES]
    assert port == ref and ref["top_n"] == 4


SPECS = ["resnet=250@120,bert=500@30", "a=1", " x = 2.5 @ 0 ", "",
         "a=1,a=2", "bad", "a=-1", "a=1@-2", "a=b", "=3"]


@pytest.mark.parametrize("spec", SPECS)
def test_model_specs_match(spec):
    def run(pkg):
        ms = _s(pkg, "modelspec")
        try:
            specs = ms.parse_model_specs(spec)
        except Exception as e:  # noqa: BLE001 - the error is the result
            return type(e).__name__, str(e)
        return ([s.to_doc() for s in specs], ms.format_model_specs(specs))

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref


def test_bucket_batcher_flushes_alike():
    def run(pkg):
        b = _s(pkg, "server")._BucketBatcher(3, 0.05)
        out = []
        t = 100.0
        for i in range(8):
            shape = (4,) if i % 3 else (2,)
            b.add(f"r{i}", f"u{i}", np.zeros(shape), t + 0.01 * i)
            out.append([(ids, reason) for ids, _, _, reason
                        in b.take_ready(t + 0.01 * i)])
        out.append((len(b), b.next_deadline()))
        out.append([(ids, reason) for ids, _, _, reason
                    in b.take_ready(t + 1.0)])
        b.add("z", "z", np.zeros(1), t)
        out.append([(ids, reason) for ids, _, _, reason in b.take_all()])
        return out

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref


@pytest.mark.parametrize("name", ["FleetController", "SloScaler",
                                  "ModelRouter", "AdmissionController"])
def test_the_fleet_plane_raises_naming_its_item(name):
    import analytics_zoo_tpu_torch.serving as serving

    with pytest.raises(NotImplementedError, match="item 17"):
        getattr(serving, name)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------
IN, N_GOOD, BATCH = 8, 19, 8


def _classifier(keras, layers):
    m = keras.Sequential()
    m.add(layers.Dense(16, activation="relu", input_shape=(IN,)))
    m.add(layers.Dense(4, activation="softmax"))
    return m


@pytest.fixture(scope="module")
def served_models():
    """The classifier in both packages, the port's with the reference's
    weights, each in an ``InferenceModel``."""
    import jax

    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jk
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu.pipeline.inference import (
        InferenceModel as JaxInference,
    )
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init
    from analytics_zoo_tpu_torch.convert import params_from_jax
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    saved = jax_engine._CONTEXT, torch_engine._CONTEXT
    jax_init(seed=5)
    torch_init(seed=5, device="cpu")
    jnet, tnet = _classifier(jk, jl), _classifier(tk, tl)
    jnet.build_params()
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    models = (JaxInference(concurrent_num=1).from_keras_net(jnet),
              InferenceModel(concurrent_num=1).from_keras_net(tnet))
    yield models
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved


def _serve(pkg, model, mode, tmp):
    """N_GOOD records and one mis-shaped one through ``pkg``'s
    ``ClusterServing`` in ``mode``; returns ({uri: answer}, served, the
    stream's backlog, the serve log's uris)."""
    br, cl, sv = _s(pkg, "broker"), _s(pkg, "client"), _s(pkg, "server")
    db = br.InMemoryBroker() if mode != "file" \
        else br.FileBroker(str(tmp / f"spool-{pkg}"))
    x = np.random.default_rng(2).standard_normal((N_GOOD, IN)) \
        .astype(np.float32)
    iq = cl.InputQueue(broker=db)
    for i, row in enumerate(x):
        iq.enqueue(f"r{i}", row)
        if i == 4:
            iq.enqueue("bad", np.zeros(IN + 1, np.float32))
    log = str(tmp / f"serve-{pkg}.log")
    server = sv.ClusterServing(
        model=model, broker=db, batch_size=BATCH, top_n=2,
        data_shape=(IN,), log_dir=str(tmp / pkg),
        owner="r0" if mode == "claim" else None,
        serve_log=log if mode == "claim" else None)
    served = server.run(max_records=N_GOOD, idle_timeout=30.0,
                        pipelined=mode != "serial")
    answers = cl.OutputQueue(broker=db).dequeue()
    uris = []
    if mode == "claim":
        with open(log) as f:
            uris = sorted(line.split()[1] for line in f)
    return answers, served, db.xlen(server.stream), uris, x


@pytest.mark.parametrize("mode", ["serial", "pipelined", "claim", "file"])
def test_cluster_serving_matches_the_reference(mode, served_models,
                                               tmp_path):
    (ra, rn, rb, ru, x), (pa, pn, pb, pu, _) = [
        _serve(p, m, mode, tmp_path)
        for p, m in zip(PACKAGES, served_models)]
    good = sorted(f"r{i}" for i in range(N_GOOD))
    assert sorted(ra) == sorted(pa) == good  # the bad record: no answer
    assert (pn, pb, pu) == (rn, rb, ru) == (
        N_GOOD, 0, good if mode == "claim" else [])
    want = served_models[1].predict(x, batch_size=BATCH)
    for uri in good:
        r, p = ra[uri], pa[uri]
        assert [c for c, _ in p] == [c for c, _ in r]
        assert np.allclose([v for _, v in p], [v for _, v in r],
                           rtol=0, atol=E2E_TOL)
        row = want[int(uri[1:])]
        assert [c for c, _ in p] == list(np.argsort(row)[::-1][:2])


def test_cluster_serving_records_the_reference_families(served_models,
                                                        tmp_path):
    """A served run creates the same serving and inference families (and
    samples) in both packages' registries."""

    def run(pkg, model):
        reg_mod = importlib.import_module(f"{pkg}.metrics.registry")
        exp = importlib.import_module(f"{pkg}.metrics.exporters")
        prev = reg_mod.set_registry(reg_mod.MetricsRegistry())
        try:
            _serve(pkg, type(model)(concurrent_num=1).from_keras_net(
                model._net), "serial", tmp_path / "fam")
            snap = exp.snapshot(reg_mod.get_registry())["samples"]
        finally:
            reg_mod.set_registry(prev)
        out = []
        for s in snap:
            if s["name"].startswith(("zoo_serving_", "zoo_inference_")):
                value = s["count"] if s["kind"] == "histogram" \
                    else s["value"]
                out.append((s["name"], s["kind"], json.dumps(
                    s.get("labels", {}), sort_keys=True), value))
        return sorted(out)

    os.makedirs(tmp_path / "fam", exist_ok=True)
    ref, port = [run(p, m) for p, m in zip(PACKAGES, served_models)]
    assert port == ref
    assert ("zoo_serving_records_total", "counter", "{}", float(N_GOOD)) \
        in port


# ---------------------------------------------------------------------------
# on the card: a small BERT over token ids, every mode against predict
# ---------------------------------------------------------------------------
SEQ_CUDA, RECORDS_CUDA = 256, 20


@pytest.fixture(scope="module")
def bert_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=11, device="cuda")
    ids = Input((SEQ_CUDA,))
    _, pooled = BERT(vocab=500, hidden_size=128, n_block=2, n_head=2,
                     seq_len=SEQ_CUDA, intermediate_size=256)(ids)
    net = Model(ids, Dense(2, activation="softmax")(pooled))
    net.build_params()
    im = InferenceModel(concurrent_num=1).from_keras_net(net)
    x = np.random.default_rng(3).integers(
        1, 500, (RECORDS_CUDA, SEQ_CUDA)).astype(np.int32)
    return im, x


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["serial", "pipelined", "claim", "file"])
def test_cluster_serving_on_the_card_equals_predict(mode, bert_on_card,
                                                    tmp_path):
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa
    from analytics_zoo_tpu_torch.serving import (
        ClusterServing,
        FileBroker,
        InMemoryBroker,
        InputQueue,
        OutputQueue,
    )

    im, x = bert_on_card
    db = FileBroker(str(tmp_path / "spool")) if mode == "file" \
        else InMemoryBroker()
    iq = InputQueue(broker=db)
    for i, row in enumerate(x):
        iq.enqueue(f"r{i}", row)
    server = ClusterServing(model=im, broker=db, batch_size=4, top_n=2,
                            data_shape=(SEQ_CUDA,), log_dir=str(tmp_path),
                            owner="r0" if mode == "claim" else None)
    before = fa.launch_count
    served = server.run(max_records=RECORDS_CUDA, idle_timeout=60.0,
                        pipelined=mode != "serial")
    launched = fa.launch_count - before
    answers = OutputQueue(broker=db).dequeue()
    want = im.predict(x, batch_size=4)
    assert served == RECORDS_CUDA and len(answers) == RECORDS_CUDA
    assert launched == 2 * RECORDS_CUDA // 4  # 2 blocks a micro-batch of 4
    for i, row in enumerate(want):
        top = np.argsort(row)[::-1][:2]
        assert answers[f"r{i}"] == [[int(c), float(row[c])] for c in top]
