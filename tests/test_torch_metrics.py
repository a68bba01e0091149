"""The port's metrics plane against the JAX package's, on the CPU.

The same sequence of operations goes through both packages' registry,
exporters, tracer, flight recorder, health registry, merge format and
scrape server; the outputs must be equal (exactly: the exposition text,
the family declarations, the verdicts), apart from the fields that carry
a clock or a process (timestamps, ``pid``, ``tid``, durations) and the
traceback's file paths.  Every metric family name, help string, label
name and bucket is the reference's, letter for letter, so one dashboard
reads both.
"""

import importlib
import json
import urllib.error
import urllib.request

import pytest

PACKAGES = ("analytics_zoo_tpu", "analytics_zoo_tpu_torch")


def _mods(sub):
    return [importlib.import_module(f"{p}.metrics.{sub}") for p in PACKAGES]


def _both(fn):
    """``fn(package_name)`` for the reference and the port."""
    return [fn(p) for p in PACKAGES]


def _m(pkg, sub="registry"):
    return importlib.import_module(f"{pkg}.metrics.{sub}")


def _workload(pkg):
    """One fixed sequence of counter, gauge and histogram operations on a
    fresh registry; returns (prometheus text, snapshot without ts)."""
    reg_mod, exp = _m(pkg), _m(pkg, "exporters")
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("zoo_test_requests_total", "requests by code",
                    ("code", "route"))
    c.labels(code="200", route="/a").inc()
    c.labels(code="200", route="/a").inc(2.5)
    c.labels(code="503", route="/b").inc()
    plain = reg.counter("zoo_test_plain_total", "no labels")
    plain.inc(7)
    g = reg.gauge("zoo_test_depth", "queue depth")
    g.set(12)
    g.inc(3)
    g.dec(4.5)
    lg = reg.gauge("zoo_test_ratio", "per device", labelnames=("device",))
    lg.labels(device="0").set(0.25)
    lg.labels(device="1").set(float("inf"))
    h = reg.histogram("zoo_test_latency_seconds", "latency")
    for v in (0.0001, 0.003, 0.02, 0.02, 0.4, 7.0, 45.0):
        h.observe(v)
    hb = reg.histogram("zoo_test_batch", "batch sizes", ("model",),
                       buckets=(1, 2, 4, 8))
    for v in (1, 3, 8, 9, 2):
        hb.labels(model="bert").observe(v)
    hb.labels(model="resnet").observe(4)
    # a name that needs sanitizing in the exposition
    reg.counter("zoo.test-odd name", "odd").inc()
    text = exp.prometheus_text(reg)
    snap = exp.snapshot(reg, step=3)
    snap.pop("ts")
    return text, snap


def test_prometheus_text_and_snapshot_match_the_reference():
    (rt, rs), (pt, ps) = _both(_workload)
    assert pt == rt
    assert ps == rs


def test_buckets_and_constants_match():
    ref, port = _mods("registry")
    assert port.DEFAULT_BUCKETS == ref.DEFAULT_BUCKETS
    rr, pr = _mods("runtime")
    assert pr.STEP_BUCKETS == rr.STEP_BUCKETS
    assert pr.BATCH_BUCKETS == rr.BATCH_BUCKETS
    from analytics_zoo_tpu.common import compile_cache as rc
    from analytics_zoo_tpu_torch.common import compile_cache as pc

    assert pc.COMPILE_BUCKETS == rc.COMPILE_BUCKETS


def _label_errors(pkg):
    reg = _m(pkg).MetricsRegistry()
    c = reg.counter("zoo_x_total", "x", ("a",))
    out = []
    for bad in (lambda: c.labels(b="1"), lambda: c.labels(),
                lambda: c.labels(a="1", b="2"),
                lambda: reg.gauge("zoo_x_total", "x", ("a",)),
                lambda: reg.counter("zoo_x_total", "x", ("z",)),
                lambda: reg.histogram("zoo_h", "h", buckets=(2, 1)),
                lambda: c.labels(a="1").inc(-1)):
        try:
            bad()
            out.append(None)
        except Exception as e:  # noqa: BLE001 - the error is the result
            out.append((type(e).__name__, str(e)))
    return out


def test_label_errors_match():
    ref, port = _both(_label_errors)
    assert port == ref
    assert any(r is not None for r in ref)


def _disabled(pkg, monkeypatch):
    reg_mod, exp = _m(pkg), _m(pkg, "exporters")
    monkeypatch.setenv("ZOO_METRICS", "0")
    monkeypatch.setattr(reg_mod, "_default", None)
    reg = reg_mod.get_registry()
    c = reg.counter("zoo_y_total", "y", ("a",))
    c.labels(a="1").inc()
    reg.histogram("zoo_h_seconds", "h").observe(1.0)
    with reg.histogram("zoo_t_seconds", "t").time():
        pass
    reg.gauge("zoo_g", "g").set(3)
    return (reg.enabled, c is reg_mod.NULL, exp.prometheus_text(reg),
            exp.snapshot(reg)["samples"])


def test_zoo_metrics_0_is_a_no_op_in_both(monkeypatch):
    ref = _disabled(PACKAGES[0], monkeypatch)
    port = _disabled(PACKAGES[1], monkeypatch)
    assert port == ref
    assert ref[:2] == (False, True) and ref[3] == []


RUNTIME = ["StepMetrics", "ServingMetrics", "DataPipelineMetrics",
           "AutotuneMetrics", "FleetMetrics", "OracleMetrics",
           "ElasticMetrics", "ScrapeMetrics", "SloMetrics", "RouterMetrics",
           "AdmissionMetrics"]


@pytest.mark.parametrize("name", RUNTIME)
def test_runtime_instruments_declare_the_reference_families(name):
    """Each instrument class declares the same families (names, help,
    kinds, labels, buckets): the exposition of a fresh registry after
    construction is equal, and so after one recording call where the
    class has one."""

    def declare(pkg):
        reg = _m(pkg).MetricsRegistry()
        inst = getattr(_m(pkg, "runtime"), name)(reg)
        if name == "StepMetrics":
            inst.record_step(0.01, 0.002, 0.05, 32, steps=2)
            inst.record_epoch(3, 640.0)
        fams = [(f.name, f.kind, f.help, tuple(f.labelnames),
                 tuple(getattr(f, "buckets", ()) or ()))
                for f in reg.collect()]
        return _m(pkg, "exporters").prometheus_text(reg), fams

    ref, port = _both(declare)
    assert port == ref
    assert ref[1]


def _trace(pkg):
    tr = _m(pkg, "tracing")
    t = tr.Tracer(True, 3, False)
    for i in range(2):
        with tr.span("outer", tracer=t, args={"i": i}):
            with tr.span("inner", tracer=t):
                pass
    doc = t.to_chrome_trace()
    events = [(e["name"], e["ph"], e["cat"], e.get("args")) for e in
              doc["traceEvents"]]
    meta = doc["metadata"]
    off = tr.Tracer(False, 3, False)
    with tr.span("x", tracer=off):
        pass
    return (events, t.dropped, meta["dropped_events"],
            sorted(meta["clock_anchor"]), sorted(meta), off.events())


def test_span_nesting_and_ring_drops_match():
    ref, port = _both(_trace)
    # the producer names the package's own module
    ref[4].remove("producer"), port[4].remove("producer")
    assert port == ref
    assert ref[1] == 1  # four events into a ring of three


def test_span_sync_on_host_tensors_is_a_no_op():
    import torch

    from analytics_zoo_tpu_torch.metrics import Tracer, span

    t = Tracer()
    with span("s", sync={"a": [torch.ones(2)], "b": 3}, tracer=t):
        pass
    assert [e["name"] for e in t.events()] == ["s"]


def _strip(ev):
    return {k: v for k, v in ev.items()
            if k not in ("ts", "mono", "traceback")}


def _flight(pkg, tmp):
    fl = _m(pkg, "flight")
    rec = fl.FlightRecorder(capacity=4, dump_dir=str(tmp / pkg))
    for i in range(3):
        rec.record("step", loop="train", step=i, step_s=0.1 * i)
    try:
        raise RuntimeError("planted fault")
    except RuntimeError as e:
        rec.record_exception(e, where="train.step")
    rec.record("ckpt", phase="start", tag="7")
    path = rec.dump("crash")
    again = rec.dump("crash")  # one file per (pid, reason)
    with open(path) as f:
        dumped = json.load(f)
    doc = rec.to_doc("live")
    tb = [e for e in dumped["events"] if e["kind"] == "exception"][0]
    return (sorted(doc), doc["reason"], doc["dropped_events"],
            [_strip(e) for e in doc["events"]], sorted(dumped),
            [_strip(e) for e in dumped["events"]], again,
            path.endswith("-crash.json"), "planted fault" in tb["traceback"])


def test_flight_recorder_doc_and_dump_on_an_exception_match(tmp_path):
    ref, port = [_flight(p, tmp_path) for p in PACKAGES]
    assert port == ref
    assert ref[2] == 1 and ref[6] is None and ref[7] and ref[8]


# loads the package's flight.py by its path: the module is stdlib-only,
# and importing it through its package would start the package's jax or
# torch import in each child process
CRASH = """
import importlib.util, os, signal, sys
spec = importlib.util.spec_from_file_location("flight", sys.argv[2])
flight = importlib.util.module_from_spec(spec)
spec.loader.exec_module(flight)
rec = flight.get_flight_recorder().install()
rec.record("step", loop="train", step=1)
if sys.argv[1] == "term":
    os.kill(os.getpid(), signal.SIGTERM)
raise RuntimeError("planted crash")
"""


@pytest.mark.parametrize("how", ["crash", "term"])
def test_installed_recorder_dumps_alike_on_a_crash_and_sigterm(how,
                                                              tmp_path):
    """``install()`` in a process that dies: an unhandled exception dumps
    ``crash`` then ``exit``, a SIGTERM dumps ``sigterm``; the files and
    their events match between the packages."""
    import os
    import subprocess
    import sys

    out = []
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for pkg in PACKAGES:
        d = tmp_path / pkg
        env = dict(os.environ, ZOO_FLIGHT_DIR=str(d))
        path = os.path.join(root, pkg, "metrics", "flight.py")
        proc = subprocess.run(
            [sys.executable, "-c", CRASH, how, path], env=env,
            capture_output=True, text=True, timeout=60)
        docs = {}
        for name in sorted(os.listdir(d)):
            with open(d / name) as f:
                doc = json.load(f)
            docs[name.split("-")[-1]] = (
                doc["reason"], [_strip(e) for e in doc["events"]])
        out.append((proc.returncode, "planted crash" in proc.stderr, docs))
    assert out[1] == out[0]
    want = {"crash": {"crash.json", "exit.json"},
            "term": {"sigterm.json"}}[how]
    assert set(out[0][2]) == want


def _stragglers(pkg):
    fl = _m(pkg, "flight")
    det = fl.StragglerDetector(k=2.0, window=16, min_steps=5)
    series = [0.1, 0.11, 0.09, 0.1, 0.12, 0.5, 0.1, 0.08, 0.31, 0.1] * 3
    verdicts = [det.observe(s) for s in series]
    board = fl.StragglerBoard(window=8, min_steps=2)
    for i in range(6):
        board.observe("w0", 0.1 + 0.001 * i)
        board.observe("w1", 0.3)
        board.observe("w2", 0.1)
    errors = []
    for bad in (lambda: fl.StragglerDetector(k=1.0),
                lambda: fl.StragglerBoard(window=0)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    return (verdicts, det.rolling_p50(), board.factors(),
            board.slowdown("w1"), board.fleet_p50(), errors)


def test_straggler_verdicts_match():
    ref, port = _both(_stragglers)
    assert port == ref
    assert any(ref[0]) and not all(ref[0])


def _health(pkg):
    hl, fl = _m(pkg, "health"), _m(pkg, "flight")
    now = [100.0]
    rec = fl.FlightRecorder()
    prev = fl.set_flight_recorder(rec)
    try:
        h = hl.HealthRegistry(clock=lambda: now[0])
        seen = [h.status()]
        h.register("loop", stale_after=10.0)
        h.register("writer", stale_after=5.0)
        seen.append(h.status())
        now[0] += 7.0
        h.heartbeat("loop")
        seen.append(h.status())  # writer stale
        h.set_status("writer", True)
        now[0] += 20.0
        seen.append(h.status())  # loop stale, writer forced healthy
        h.heartbeat("loop")
        h.set_status("writer", False)
        seen.append(h.status())
        h.unregister("writer")
        h.heartbeat("auto")  # auto-registered
        seen.append(h.status())
    finally:
        fl.set_flight_recorder(prev)
    return seen, [_strip(e) for e in rec.events()]


def test_health_goes_through_the_same_transitions():
    ref, port = _both(_health)
    assert port == ref
    assert [s["healthy"] for s in ref[0]] == [True, True, False, False,
                                             False, True]


def _merge(pkg):
    reg_mod, mg = _m(pkg), _m(pkg, "merge")
    snaps = []
    for k in range(2):
        reg = reg_mod.MetricsRegistry()
        reg.counter("zoo_m_total", "m", ("a",)).labels(a="x").inc(k + 1)
        h = reg.histogram("zoo_m_seconds", "m")
        for v in (0.01 * (k + 1), 0.5, 3.0):
            h.observe(v)
        reg.gauge("zoo_m_depth", "d").set(5 * k)
        snaps.append(mg.telemetry_snapshot(reg))
    samples = [s["samples"] for s in snaps]
    merged = mg.merge_samples(samples)
    agg = mg.TelemetryAggregator()
    for i, s in enumerate(snaps):
        agg.ingest(s, worker=f"w{i}")
    out = agg.merged(include_driver=False)
    return (sorted(snaps[0]), merged, mg.samples_to_prometheus(merged),
            agg.labeled_samples(), out["totals"], agg.prometheus_text())


def test_merge_format_and_aggregator_match():
    ref, port = _both(_merge)
    assert port == ref


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _server(pkg):
    reg_mod, http, tr, hl, fl = (_m(pkg), _m(pkg, "http"),
                                 _m(pkg, "tracing"), _m(pkg, "health"),
                                 _m(pkg, "flight"))
    reg = reg_mod.MetricsRegistry()
    reg.counter("zoo_s_total", "s").inc(2)
    tracer = tr.Tracer(True, 10, False)
    with tr.span("zoo.s", tracer=tracer):
        pass
    health = hl.HealthRegistry()
    health.register("loop")
    flight = fl.FlightRecorder()
    flight.record("step", step=1)
    srv = http.MetricsServer(port=0, registry=reg, tracer=tracer,
                             health=health, flight=flight).start()
    out = {}
    try:
        assert srv.port > 0
        for ep in ("/metrics", "/varz", "/trace", "/healthz", "/flightz",
                   "/telemetryz", "/alertz", "/nope"):
            code, body = _get(srv.url + ep)
            if ep == "/metrics":
                out[ep] = (code, body)
            else:
                try:
                    doc = json.loads(body)
                    out[ep] = (code, sorted(doc) if isinstance(doc, dict)
                               else type(doc).__name__)
                except ValueError:
                    out[ep] = (code, "text")
        health.set_status("loop", False)
        out["unhealthy"] = _get(srv.url + "/healthz")[0]
    finally:
        srv.stop()
    return out


# /varz panels of modules the port does not have yet (ROADMAP queue 1
# items 19, 21): the reference shows each one whose module this process
# has imported; the port's server looks its own module names up and
# answers as "not running"
PANELS = {"oracle", "elastic"}


def test_metrics_server_endpoints_and_keys_match():
    # the autotune, fleet, router, admission, slo and scrape panels are
    # ported: each package's /varz shows one once its own module is
    # imported (slo and scrape come with the metrics package), so all are
    for pkg in PACKAGES:
        for mod in ("feature.autotune", "serving.fleet", "serving.router",
                    "serving.admission"):
            importlib.import_module(f"{pkg}.{mod}")
    ref, port = _both(_server)
    code, keys = port["/varz"]
    assert not PANELS & set(keys)
    assert {"autotune", "fleet", "router", "admission", "slo",
            "scrape"} <= set(keys)
    ref["/varz"] = (ref["/varz"][0],
                    [k for k in ref["/varz"][1] if k not in PANELS])
    assert port == ref
    assert ref["/metrics"][0] == 200 and ref["unhealthy"] == 503


def test_tensorboard_exporter_writes_the_port_event_files(tmp_path):
    from analytics_zoo_tpu.metrics import TensorBoardExporter as RefTB
    from analytics_zoo_tpu.tensorboard import TrainSummary as RefWriter
    from analytics_zoo_tpu_torch.metrics import TensorBoardExporter
    from analytics_zoo_tpu_torch.tensorboard import TrainSummary

    def run(exporter, writer_cls, pkg, d):
        reg = _m(pkg).MetricsRegistry()
        reg.counter("zoo_t_total", "t", ("a",)).labels(a="1").inc(3)
        for v in (0.1, 0.2, 0.3):
            reg.histogram("zoo_t_seconds", "t").observe(v)
        w = writer_cls(str(d), "app")
        n = exporter(w, reg).export(step=5)
        got = [[row[:2] for row in w.read_scalar(t)] for t in ('zoo_t_total{a="1"}',
                                          "zoo_t_seconds/p50",
                                          "zoo_t_seconds/count")]
        w.close()
        return n, got

    ref = run(RefTB, RefWriter, PACKAGES[0], tmp_path / "ref")
    port = run(TensorBoardExporter, TrainSummary, PACKAGES[1],
               tmp_path / "port")
    assert port == ref and ref[0] > 1


def test_sanitizers_and_sample_keys_match():
    ref, port = _mods("exporters")
    names = ["zoo.a-b c", "9lives", "ok_name", "a:b", ""]
    assert [port.sanitize_metric_name(n) for n in names] == [
        ref.sanitize_metric_name(n) for n in names]
    assert [port.sanitize_label_name(n) for n in names] == [
        ref.sanitize_label_name(n) for n in names]
    s = {"name": "zoo_x", "labels": {"b": "2", "a": "1"}}
    assert port.sample_key(s) == ref.sample_key(s)


@pytest.mark.parametrize("name", ["VarzScraper", "fleet_varz_targets",
                                  "SloEngine", "SloSpec", "default_slos",
                                  "TimeSeriesStore"])
def test_the_federation_tier_raises_naming_its_item(name):
    """These names raised (item 18) until the federation tier was ported;
    the case now checks each is exported from its own module (the id
    stays the same)."""
    import importlib

    import analytics_zoo_tpu_torch.metrics as metrics

    mod = {"VarzScraper": "scrape", "fleet_varz_targets": "scrape",
           "SloEngine": "slo", "SloSpec": "slo", "default_slos": "slo",
           "TimeSeriesStore": "timeseries"}[name]
    assert name in metrics.__all__
    assert getattr(metrics, name) is getattr(importlib.import_module(
        f"analytics_zoo_tpu_torch.metrics.{mod}"), name)


def test_every_reference_name_is_exported_or_raises():
    """Every name of the reference's metrics package is exported (the
    federation tier, the last that raised, is ported)."""
    import analytics_zoo_tpu.metrics as ref
    import analytics_zoo_tpu_torch.metrics as port

    for name in ref.__all__:
        assert name in port.__all__, name
        getattr(port, name)
    assert not hasattr(port, "UNPORTED")


def test_record_device_memory_is_zero_without_a_cuda_device():
    import torch

    from analytics_zoo_tpu_torch.metrics import (
        MetricsRegistry,
        record_device_memory,
    )

    reg = MetricsRegistry()
    assert not torch.cuda.is_available()
    assert record_device_memory(reg) == 0
    assert reg.collect() == []


def test_record_device_memory_reads_only_the_devices_in_use(monkeypatch):
    """On a host that shows four GPUs, a process that put memory only on
    device 1 reports that one: ``mem_get_info`` (which would create a
    CUDA context) is asked of no other device."""
    import torch

    from analytics_zoo_tpu_torch.metrics import (
        MetricsRegistry,
        record_device_memory,
    )
    from analytics_zoo_tpu_torch.metrics.exporters import snapshot

    used = {1: {"reserved_bytes.all.peak": 4096,
                "allocated_bytes.all.current": 1024,
                "allocated_bytes.all.peak": 2048}}
    asked = []

    def mem_get_info(i):
        asked.append(i)
        return (0, 80 << 30)

    for name, fn in (("is_available", lambda: True),
                     ("is_initialized", lambda: True),
                     ("device_count", lambda: 4),
                     ("memory_stats", lambda i: dict(used.get(i, {
                         "reserved_bytes.all.peak": 0}))),
                     ("mem_get_info", mem_get_info)):
        monkeypatch.setattr(torch.cuda, name, fn)
    reg = MetricsRegistry()
    assert record_device_memory(reg) == 1
    assert asked == [1]
    got = {(s["name"], s["labels"]["device"]): s["value"]
           for s in snapshot(reg)["samples"]}
    assert got == {("zoo_device_bytes_in_use", "1"): 1024,
                   ("zoo_device_peak_bytes_in_use", "1"): 2048,
                   ("zoo_device_bytes_limit", "1"): 80 << 30}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert record_device_memory(MetricsRegistry()) == 0
