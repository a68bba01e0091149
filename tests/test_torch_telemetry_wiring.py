"""The port's fit, predict and checkpoints report what the JAX package's
report, on the CPU.

The same Dense classifier, data and batch size go through both packages'
``fit`` (two epochs of four steps; the reference's CPU mesh has 8
devices, so the batch is 8) and ``InferenceModel.predict`` (11 records at
batch 8: buckets 8 and 4), each into a fresh registry and flight
recorder.  Every family the port creates is the reference's (name, kind,
help, labels), with the same samples: step, record and compile counts,
histogram counts, the epoch gauge (the throughput gauge is a clock).  The
families the reference has beyond those belong to planes the port does
not have: the HLO analysis (``zoo_hlo_*``, ROADMAP queue 1 item 19) and
the memory planner (``zoo_mem_*``, item 13).  The checkpoint writer's
families and ``ckpt`` flight events match too.  A fit with the metrics
plane off (``ZOO_METRICS=0``) trains the same parameters bit for bit
(one thread: the CPU's embedding and matmul sums are thread-ordered).
"""

import importlib
import json

import numpy as np
import pytest
import torch

PACKAGES = ("analytics_zoo_tpu", "analytics_zoo_tpu_torch")
UNPORTED_PREFIXES = ("zoo_hlo_", "zoo_mem_")
CLOCKS = ("zoo_train_throughput_records_per_sec",)


def _m(pkg, sub):
    return importlib.import_module(f"{pkg}.metrics.{sub}")


def _data():
    gen = np.random.default_rng(0)
    x = gen.standard_normal((32, 8)).astype(np.float32)
    return x, gen.integers(0, 4, 32).astype(np.int32)


def _model(pkg):
    zoo = importlib.import_module(pkg)
    zoo.init_zoo_context(seed=3, **({"device": "cpu"}
                                    if pkg.endswith("torch") else {}))
    keras = importlib.import_module(f"{pkg}.pipeline.api.keras")
    layers = importlib.import_module(f"{pkg}.pipeline.api.keras.layers")
    m = keras.Sequential()
    m.add(layers.Dense(16, activation="relu", input_shape=(8,)))
    m.add(layers.Dense(4, activation="softmax"))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    return m


class _Plane:
    """A fresh registry, tracer, flight recorder and health registry for
    ``pkg`` while the block runs (the enabled flag for the registry and
    tracer), the previous ones restored after: what other tests left in
    a process-wide one (a serving or prefetch component) never shows."""

    def __init__(self, pkg, enabled=True):
        self.pkg, self.enabled = pkg, enabled

    def __enter__(self):
        reg, tr, fl, hl = (_m(self.pkg, "registry"),
                           _m(self.pkg, "tracing"), _m(self.pkg, "flight"),
                           _m(self.pkg, "health"))
        self.reg = reg.MetricsRegistry(enabled=self.enabled)
        self.tracer = tr.Tracer(self.enabled, 10_000, False)
        self.flight = fl.FlightRecorder(enabled=self.enabled)
        self.saved = (reg.set_registry(self.reg),
                      tr.set_tracer(self.tracer),
                      fl.set_flight_recorder(self.flight),
                      hl.set_health(hl.HealthRegistry()))
        return self

    def __exit__(self, *exc):
        _m(self.pkg, "registry").set_registry(self.saved[0])
        _m(self.pkg, "tracing").set_tracer(self.saved[1])
        _m(self.pkg, "flight").set_flight_recorder(self.saved[2])
        _m(self.pkg, "health").set_health(self.saved[3])
        return False


@pytest.fixture(scope="module")
def runs():
    """Each package's fit and predict, with what they recorded."""
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine

    saved = jax_engine._CONTEXT, torch_engine._CONTEXT, \
        torch.get_num_threads()
    torch.set_num_threads(1)
    x, y = _data()
    out = {}
    try:
        for pkg in PACKAGES:
            with _Plane(pkg) as plane:
                m = _model(pkg)
                m.fit(x, y, batch_size=8, nb_epoch=2)
                im = importlib.import_module(
                    f"{pkg}.pipeline.inference").InferenceModel()
                im.from_keras_net(m)
                im.predict(x[:11], batch_size=8)
                im.predict(x[:8], batch_size=8)  # a second bucket-8 call
                out[pkg] = {
                    "families": {f.name: (f.kind, f.help,
                                          tuple(f.labelnames))
                                 for f in plane.reg.collect()},
                    "samples": _m(pkg, "exporters").snapshot(
                        plane.reg)["samples"],
                    "flight": plane.flight.events(),
                    "spans": [e["name"] for e in plane.tracer.events()],
                    "health": _m(pkg, "health").get_health().status(),
                }
    finally:
        jax_engine._CONTEXT, torch_engine._CONTEXT = saved[:2]
        torch.set_num_threads(saved[2])
    return out


def test_fit_and_predict_create_the_reference_families(runs):
    ref, port = (runs[p]["families"] for p in PACKAGES)
    for name, decl in port.items():
        assert ref.get(name) == decl, name
    extra = sorted(n for n in ref if n not in port)
    assert extra and all(n.startswith(UNPORTED_PREFIXES) for n in extra), \
        extra
    assert {"zoo_train_steps_total", "zoo_train_records_total",
            "zoo_inference_compiles_total", "zoo_inference_records_total",
            "zoo_compile_seconds"} <= set(port)


def _values(samples):
    out = {}
    for s in samples:
        if s["name"].startswith(UNPORTED_PREFIXES) or s["name"] in CLOCKS:
            continue
        value = s["count"] if s["kind"] == "histogram" else s["value"]
        out[s["name"], json.dumps(s.get("labels", {}),
                                  sort_keys=True)] = value
    return out


def test_step_record_and_compile_counts_match(runs):
    ref, port = (_values(runs[p]["samples"]) for p in PACKAGES)
    assert port == ref
    assert port["zoo_train_steps_total", "{}"] == 8
    assert port["zoo_train_records_total", "{}"] == 64
    assert port["zoo_inference_records_total", "{}"] == 19
    assert port["zoo_inference_compiles_total", '{"bucket": "8"}'] == 1
    assert port["zoo_inference_predict_seconds", '{"bucket": "8"}'] == 2


def test_step_flight_records_match(runs):
    def steps(pkg):
        evs = [e for e in runs[pkg]["flight"] if e["kind"] == "step"]
        return [(sorted(e), e["loop"], e["step"], e["epoch"]) for e in evs]

    ref, port = (steps(p) for p in PACKAGES)
    assert port == ref and len(port) == 8


def test_train_loop_leaves_health_and_spans_alike(runs):
    ref, port = (runs[p] for p in PACKAGES)
    assert "train_loop" not in port["health"]["components"]
    assert sorted(port["health"]["components"]) == sorted(
        ref["health"]["components"])
    assert port["spans"].count("zoo.train.step_dispatch") == \
        ref["spans"].count("zoo.train.step_dispatch") == 8
    assert port["spans"].count("zoo.inference.compile") == \
        ref["spans"].count("zoo.inference.compile") == 2


def test_checkpoint_telemetry_matches(tmp_path, monkeypatch):
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine

    monkeypatch.setenv("ZOO_ASYNC_CHECKPOINT", "0")
    saved = jax_engine._CONTEXT, torch_engine._CONTEXT
    x, y = _data()
    out = []
    try:
        for pkg in PACKAGES:
            with _Plane(pkg) as plane:
                m = _model(pkg)
                m.set_checkpoint(str(tmp_path / pkg))
                m.fit(x, y, batch_size=8, nb_epoch=2)
                vals = {k: v for k, v in _values(_m(
                    pkg, "exporters").snapshot(plane.reg)["samples"]).items()
                    if k[0].startswith("zoo_ckpt_")}
                ckpt = [(e["phase"], e["tag"]) for e in
                        plane.flight.events("ckpt")]
                health = _m(pkg, "health").get_health().status()
                out.append((vals, ckpt, health["components"].get(
                    "checkpoint_writer", {}).get("forced")))
    finally:
        jax_engine._CONTEXT, torch_engine._CONTEXT = saved
    assert out[1] == out[0]
    assert out[0][0][("zoo_ckpt_writes_total", "{}")] >= 2


def test_a_fit_with_the_plane_off_trains_the_same_parameters():
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu_torch.common.utils import tree_leaves

    saved = torch_engine._CONTEXT, torch.get_num_threads()
    torch.set_num_threads(1)
    x, y = _data()
    trained = []
    try:
        for on in (True, False):
            with _Plane(PACKAGES[1], enabled=on) as plane:
                m = _model(PACKAGES[1])
                m.fit(x, y, batch_size=8, nb_epoch=2)
                trained.append(tree_leaves(m.params))
                assert bool(plane.reg.collect()) is on
    finally:
        torch_engine._CONTEXT = saved[0]
        torch.set_num_threads(saved[1])
    assert all(torch.equal(a, b) for a, b in zip(*trained))


def test_timed_compile_feeds_the_registry():
    from analytics_zoo_tpu_torch.common import compile_cache
    from analytics_zoo_tpu_torch.metrics import MetricsRegistry, snapshot

    with _Plane(PACKAGES[1]) as plane:
        assert compile_cache.timed_compile(lambda: 5, "probe") == 5
        compile_cache.timed_compile(lambda: 6, "probe", hit=True)
        compile_cache.record("probe", hit=True)  # a replay: stats only
        vals = _values(snapshot(plane.reg)["samples"])
    assert isinstance(plane.reg, MetricsRegistry)
    assert vals == {("zoo_compile_seconds", '{"label": "probe"}'): 2,
                    ("zoo_compile_cache_hits_total",
                     '{"label": "probe"}'): 1.0,
                    ("zoo_compile_cache_misses_total",
                     '{"label": "probe"}'): 1.0}
    assert compile_cache.compile_stats()["probe"]["hits"] >= 2


@pytest.mark.parametrize("field,value", [("serving_batch_budget_ms", 5.0),
                                         ("fleet_lease_ms", 500)])
def test_ported_serving_knobs_are_accepted(monkeypatch, tmp_path, field,
                                           value):
    """The two serving knobs no longer raise in ``init_zoo_context``, and
    ``ClusterServingHelper`` serves with a value given there, over its env
    var (the ZooConfig precedence), whether it came as a conf entry or a
    ``ZooConfig``; its own override still wins.  A context not given the
    knob leaves the helper to its env var.  The fleet plane's other knobs
    still raise."""
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import ZooConfig
    from analytics_zoo_tpu_torch.serving import ClusterServingHelper

    attr, env, env_value = {
        "serving_batch_budget_ms": ("batch_budget_ms",
                                    "ZOO_SERVING_BATCH_BUDGET_MS", 7.0),
        "fleet_lease_ms": ("lease_ms", "ZOO_FLEET_LEASE_MS", 700)}[field]
    monkeypatch.setenv(env, str(env_value))

    def helper(**kw):
        return getattr(ClusterServingHelper(log_dir=str(tmp_path), **kw),
                       attr)

    saved = torch_engine._CONTEXT
    try:
        for conf in ({field: value}, ZooConfig(**{field: value})):
            ctx = init_zoo_context(conf, device="cpu", steps_per_dispatch=1)
            assert getattr(ctx.config, field) == value
            assert helper() == value
            assert helper(**{attr: 300}) == 300
        init_zoo_context(device="cpu")
        assert helper() == env_value
        with pytest.raises(NotImplementedError, match="item 17"):
            init_zoo_context({"fleet_max_replicas": 8}, device="cpu")
    finally:
        torch_engine._CONTEXT = saved
