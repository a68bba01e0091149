"""The federation tier of the port's metrics plane against the JAX
package's: time-series windows (``metrics/timeseries.py``), the SLO
engine (``metrics/slo.py``), the scraper (``metrics/scrape.py``) and the
federated scaler signals (``serving/scaler.py``).  The same samples go
into both packages; every query and transition must come out equal (all
host code, no tolerance)."""

import http.server
import importlib
import json
import threading
import time

import numpy as np
import pytest

PACKAGES = ("analytics_zoo_tpu", "analytics_zoo_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _samples(pkg, step, gen_seed=0):
    """The mergeable samples of a registry after ``step`` rounds of seeded
    observations: a predict histogram, a records counter (reset once, at
    round 7) and a memory gauge, as a replica would report them."""
    reg = _mod(pkg, "metrics.registry").MetricsRegistry()
    h = reg.histogram("zoo_serving_predict_seconds", "p",
                      buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0))
    c = reg.counter("zoo_serving_records_total", "r")
    g = reg.gauge("zoo_mem_ratio", "m")
    gen = np.random.default_rng(gen_seed)
    first = 7 if step >= 7 else 0
    for i in range(step + 1):
        lat = gen.gamma(2.0, 0.04 + 0.03 * (i % 5), size=8)
        if i >= first:
            for v in lat:
                h.observe(float(v))
            c.inc(8 + i)
        g.set(float(gen.random()))
    return _mod(pkg, "metrics.merge").registry_samples(reg)


def _filled_store(pkg, hosts=("h1", "h2"), rounds=12):
    ts = _mod(pkg, "metrics.timeseries")
    st = ts.TimeSeriesStore(capacity=64, clock=lambda: 100.0 + rounds)
    for r in range(rounds):
        for k, host in enumerate(hosts):
            st.ingest(_samples(pkg, r, gen_seed=k), ts=100.0 + r,
                      source={"host": host})
    return st


def _queries(pkg):
    st = _filled_store(pkg)
    out = []
    for window in (2.5, 5.0, 11.0, 30.0):
        for labels in (None, {"host": "h1"}, {"host": "h2"}):
            out.append(st.rate("zoo_serving_records_total", window,
                               labels=labels))
            out.append(st.window_summary("zoo_serving_predict_seconds",
                                         window, labels=labels))
            for q in (0.5, 0.95, 0.99):
                out.append(st.percentile_over(
                    "zoo_serving_predict_seconds", q, window,
                    labels=labels))
            for thr in (0.03, 0.1, 0.3, 2.0):
                out.append(st.bad_fraction("zoo_serving_predict_seconds",
                                           thr, window, labels=labels))
                out.append(st.bad_fraction("zoo_mem_ratio", thr * 3,
                                           window, labels=labels))
                out.append(st.burn_rate("zoo_serving_predict_seconds",
                                        thr, 0.95, window, labels=labels))
    out.append(sorted(st.series()))
    out.append(st.label_sets("zoo_mem_ratio"))
    fle = _mod(pkg, "metrics.timeseries").fraction_le
    bounds = (0.01, 0.05, 0.1, 0.25)
    for counts in ([0, 0, 0, 0, 0], [3, 1, 4, 1, 5], [0, 9, 2, 6, 5]):
        for thr in (0.0, 0.005, 0.07, 0.25, 9.0):
            out.append(fle(bounds, counts, thr))
    return out


def test_time_series_queries_match_the_reference():
    ref, port = [_queries(p) for p in PACKAGES]
    assert port == ref
    assert any(isinstance(v, float) and 0.0 < v < 1.0 for v in ref)


def test_time_series_store_bounds_match_the_reference():
    def run(pkg):
        ts = _mod(pkg, "metrics.timeseries")
        out = []
        with pytest.raises(ValueError) as e:
            ts.TimeSeriesStore(capacity=1)
        out.append(str(e.value))
        st = ts.TimeSeriesStore(capacity=3, max_series=2)
        for i in range(5):
            st.observe(f"zoo_g{i % 3}", i, ts=float(i))
        out.append((st.dropped_series, st.series()))
        with pytest.raises(ValueError) as e:
            st.percentile_over("zoo_g0", 0.9, 10.0, now=5.0)
        out.append(str(e.value))
        with pytest.raises(ValueError) as e:
            st.burn_rate("zoo_g0", 1.0, 1.0, 10.0, now=5.0)
        out.append(str(e.value))
        return out

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref


class _Flight:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append((kind, fields))

    def record_exception(self, exc, **fields):
        self.events.append(("exception", repr(exc)))


def _engine_run(pkg):
    """An SLO engine over a store fed a latency episode: quiet, a burst
    of slow predicts, quiet again; stale scrape targets as a gauge."""
    reg_mod = _mod(pkg, "metrics.registry")
    merge = _mod(pkg, "metrics.merge")
    slo = _mod(pkg, "metrics.slo")
    st = _mod(pkg, "metrics.timeseries").TimeSeriesStore(capacity=256)
    flight = _Flight()
    specs = slo.default_slos(slo_p99_ms=200.0, short_window=5.0,
                             long_window=20.0, burn_threshold=2.0)
    eng = slo.SloEngine(st, specs, registry=reg_mod.MetricsRegistry(),
                        flight=flight)
    reg = reg_mod.MetricsRegistry()
    h = reg.histogram("zoo_serving_predict_seconds", "p")
    gen = np.random.default_rng(3)
    firing = []
    for t in range(60):
        slow = 15 <= t < 32
        for v in gen.gamma(2.0, 0.15 if slow else 0.02, size=6):
            h.observe(float(v))
        st.ingest(merge.registry_samples(reg), ts=float(t),
                  source={"host": "r0"})
        st.observe("zoo_scrape_staleness_seconds",
                   30.0 if 40 <= t < 50 else 0.5,
                   labels={"target": "r0"}, ts=float(t))
        firing.append(sorted(a["slo"] for a in eng.evaluate(now=float(t))))
    log = eng.decision_log()
    return firing, log, flight.events, eng.alerts(), \
        [s.to_doc() for s in eng.specs()]


def test_slo_engine_makes_the_reference_transitions():
    ref, port = [_engine_run(p) for p in PACKAGES]
    assert port == ref
    states = [(d["slo"], d["state"]) for d in ref[1]]
    assert ("predict_latency", "firing") in states
    assert ("predict_latency", "resolved") in states
    assert ("worker_heartbeat", "firing") in states


def test_slo_spec_validation_matches_the_reference():
    bad = [dict(objective=1.0), dict(threshold=0.0),
           dict(short_window=10.0, long_window=5.0), dict(kind="p99"),
           dict(burn_threshold=0.0)]

    def run(pkg):
        slo = _mod(pkg, "metrics.slo")
        out = []
        for kw in bad:
            with pytest.raises(ValueError) as e:
                slo.SloSpec("s", "f", **{"threshold": 1.0, **kw})
            out.append(str(e.value))
        out.append([s.to_doc() for s in slo.default_slos()])
        return out

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref


def test_alertz_and_the_slo_panel_serve_the_port_engine():
    from analytics_zoo_tpu_torch.metrics import (
        MetricsRegistry,
        MetricsServer,
    )
    from analytics_zoo_tpu_torch.metrics.slo import SloEngine, SloSpec
    from analytics_zoo_tpu_torch.metrics.timeseries import TimeSeriesStore

    st = TimeSeriesStore()
    for t, v in enumerate((5.0, 6.0, 7.0)):
        st.observe("zoo_g", v, ts=1000.0 + t)
    eng = SloEngine(st, [SloSpec("g", "zoo_g", threshold=1.0,
                                 kind="ceiling", short_window=5.0,
                                 long_window=10.0)],
                    registry=MetricsRegistry(), flight=_Flight())
    eng.evaluate(now=1002.0)
    srv = MetricsServer(port=0, host="127.0.0.1",
                        registry=MetricsRegistry()).start()
    try:
        alertz = json.loads(urllib_get(srv.url + "/alertz")[1])
        varz = json.loads(urllib_get(srv.url + "/varz")[1])
    finally:
        srv.stop()
    assert any(a["slo"] == "g" and a["firing"] for a in alertz["firing"])
    assert any(doc["alerts"] and doc["alerts"][0]["slo"] == "g"
               for doc in varz["slo"])


def urllib_get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_scraper_pulls_a_live_port_server():
    """A ``VarzScraper`` of each package over the port's ``MetricsServer``
    on port 0: the same pulls, per-host series, staleness series and
    health verdict."""
    from analytics_zoo_tpu_torch.metrics import MetricsRegistry, MetricsServer

    reg = MetricsRegistry()
    reg.counter("zoo_demo_total", "d").inc(3)
    reg.histogram("zoo_demo_seconds", "d", buckets=(0.1, 1.0)).observe(0.05)
    srv = MetricsServer(port=0, host="127.0.0.1", registry=reg).start()

    def run(pkg):
        scrape = _mod(pkg, "metrics.scrape")
        health = _mod(pkg, "metrics.health").HealthRegistry()
        st = _mod(pkg, "metrics.timeseries").TimeSeriesStore()
        agg = _mod(pkg, "metrics.merge").TelemetryAggregator()
        sc = scrape.VarzScraper(targets=[("r1", srv.url)], store=st,
                                aggregator=agg, interval=0.1,
                                health=health, clock=lambda: 50.0)
        n = sc.poll_once()
        hz = sc.healthz()
        return (n, hz["healthy"], hz["targets"]["r1"]["fetches"],
                st.label_sets("zoo_demo_total"),
                bool(st.label_sets("zoo_demo_seconds")),
                st.label_sets("zoo_scrape_staleness_seconds"),
                sorted(agg.sources()), health.status()["healthy"])

    try:
        ref, port = [run(p) for p in PACKAGES]
    finally:
        srv.stop()
    assert port == ref
    assert port[0] == 1 and port[1] is True


def test_scraper_falls_back_to_varz_and_flags_dead_targets():
    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/telemetryz":  # a target predating the route
                self.send_error(404)
                return
            body = json.dumps({"ts": time.time(), "samples": [
                {"name": "zoo_old_total", "kind": "counter", "value": 2.0},
                {"name": "zoo_old_seconds", "kind": "histogram",
                 "sum": 1.0, "count": 2},
            ]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    dead = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    dead_port = dead.server_address[1]
    dead.server_close()  # a port nothing answers on

    def run(pkg):
        scrape = _mod(pkg, "metrics.scrape")
        st = _mod(pkg, "metrics.timeseries").TimeSeriesStore()
        sc = scrape.VarzScraper(
            targets=[f"127.0.0.1:{httpd.server_address[1]}",
                     ("dead", f"127.0.0.1:{dead_port}")],
            store=st, interval=0.1, timeout=0.5,
            health=_mod(pkg, "metrics.health").HealthRegistry())
        n = sc.poll_once()
        hz = sc.healthz()
        return (n, bool(st.label_sets("zoo_old_total")),
                bool(st.label_sets("zoo_old_seconds")), hz["healthy"],
                hz["targets"]["dead"]["healthy"],
                hz["targets"]["dead"]["errors"],
                hz["targets"]["dead"]["age_seconds"])

    try:
        ref, port = [run(p) for p in PACKAGES]
    finally:
        httpd.shutdown()
    assert port == ref == (1, True, False, False, False, 1, None)


def test_target_parsing_and_fleet_discovery_match():
    def run(pkg):
        scrape = _mod(pkg, "metrics.scrape")
        broker = _mod(pkg, "serving.broker").connect_broker("memory")
        broker.hset(scrape.VARZ_KEY_PREFIX + "rep-3",
                    {"url": "http://127.0.0.1:7777", "ts": "1"})
        broker.hset(scrape.VARZ_KEY_PREFIX + "rep-4", {"ts": "1"})
        return (scrape.VARZ_KEY_PREFIX,
                [scrape.normalize_target(t) for t in
                 ("h:1", "http://h:2/varz", ("n", "h:3"), "https://h:4")],
                scrape.targets_from_env({"ZOO_SCRAPE_TARGETS":
                                         "a:1, b:2 http://c:3/x"}),
                scrape.fleet_varz_targets(broker)())

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref
    assert port[-1] == {"rep-3": "http://127.0.0.1:7777"}


def test_elastic_discovery_raises_naming_its_item():
    from analytics_zoo_tpu_torch.metrics.scrape import elastic_varz_targets
    from analytics_zoo_tpu_torch.serving import InMemoryBroker

    with pytest.raises(NotImplementedError, match="item 21"):
        elastic_varz_targets(InMemoryBroker(), "__zoo-elastic-")


class _Broker:
    def __init__(self, queue, mem):
        self._q, self._m = queue, mem

    def unclaimed(self, stream):
        return self._q

    def memory_ratio(self):
        return self._m


def _federated(pkg):
    scaler = _mod(pkg, "serving.scaler")
    st = _filled_store(pkg, hosts=("h1", "h2", "h3"))
    out = []
    for queue, mem in ((0, 0.0), (40, 0.1), (400, 0.2), (10, 0.6)):
        fed = scaler.FederatedSignalSource(st, _Broker(queue, mem), "s")
        for window in (3.0, 9.0):
            sig = fed.gather(window)
            out.append(sig.__dict__)
            sc = scaler.SloScaler(slo_p99_ms=150.0, max_replicas=8,
                                  up_windows=1, down_windows=1)
            for replicas, hosts in ((1, 1), (2, 1), (4, 2), (6, 3)):
                out.append(sc.decide_fleet(replicas, hosts, sig))
                out.append(sc.decide_fleet(replicas, hosts, sig,
                                           replicas_per_host=2,
                                           max_hosts=3))
        out.append(fed.host_count())
    return out


def test_federated_signals_and_fleet_decisions_match():
    ref, port = [_federated(p) for p in PACKAGES]
    assert port == ref
    assert any(isinstance(d, tuple) and d[0] > 1 for d in ref)


def test_a_dead_discovered_target_goes_stale_in_healthz():
    """A discovered target that stops answering goes stale in the port's
    health rollup once ``stale_after`` passes.  The reference re-registers
    (and so re-beats) a target's component on every discovery, so there it
    stays healthy while its broker key lives; the scraper's own rollup
    flags it in both packages."""
    def run(pkg):
        scrape = _mod(pkg, "metrics.scrape")
        now = [100.0]
        health = _mod(pkg, "metrics.health").HealthRegistry(
            clock=lambda: now[0])
        dead = f"127.0.0.1:{_dead_port()}"
        sc = scrape.VarzScraper(interval=1.0, stale_after=2.0, timeout=0.2,
                                health=health, clock=lambda: now[0],
                                discover=lambda: {"gone": dead})
        out = []
        for _ in range(4):
            sc.poll_once()
            now[0] += 1.0
            out.append((health.status()["healthy"],
                        sc.healthz()["targets"]["gone"]["healthy"]))
        return out

    ref, port = [run(p) for p in PACKAGES]
    assert [r[1] for r in ref] == [r[1] for r in port] == [False] * 4
    assert [r[0] for r in port] == [True, True, False, False]
    assert [r[0] for r in ref] == [True] * 4


def _dead_port():
    srv = http.server.HTTPServer(("127.0.0.1", 0),
                                 http.server.BaseHTTPRequestHandler)
    port = srv.server_address[1]
    srv.server_close()
    return port
