"""HTTP scrape endpoints — the process's telemetry served over stdlib HTTP.

:class:`MetricsServer` is a ``ThreadingHTTPServer`` on a daemon thread
exposing the observability subsystem to scrapers, load balancers and
humans with curl:

====================  ====================================================
``/metrics``          Prometheus text exposition (``exporters.
                      prometheus_text``); on an aggregating process the
                      pod's per-source series are appended after the
                      local registry's.
``/varz``             one JSON registry snapshot (the JSONL line shape),
                      plus health, tracer-drop and flight counters —
                      ``tools/metrics_dump.py --url`` renders it.
``/trace``            Chrome-trace JSON from the Tracer ring (load in
                      ``chrome://tracing`` / Perfetto).
``/healthz``          200 when every registered component heartbeat is
                      fresh, 503 with the stale components otherwise
                      (health.py rollup) — the readiness-probe contract.
``/flightz``          the flight recorder ring as JSON (flight.py).
``/telemetryz``       the MERGEABLE snapshot (``merge.telemetry_
                      snapshot``): histogram samples keep their bucket
                      vectors, so a federation scraper (metrics/
                      scrape.py) can ingest them into a
                      ``TelemetryAggregator``/``TimeSeriesStore`` —
                      /varz histograms are lossy summaries.
``/alertz``           SLO burn-rate alert state across every live
                      ``SloEngine`` (metrics/slo.py): firing + latest
                      verdict per spec.  Empty doc when no engine runs.
====================  ====================================================

``port=0`` binds an ephemeral port (tests read :attr:`MetricsServer.port`
after :meth:`start`); :meth:`stop` shuts the listener down cleanly.
Opt-in from production entry points is one env var::

    ZOO_METRICS_PORT=9090 python serve.py      # ClusterServing.run()
    ZOO_METRICS_PORT=9090 python train.py      # estimator fit loop

both call :func:`maybe_start_from_env`, which starts ONE server per
process (idempotent) and leaves the process untouched when the var is
unset.  The bind address defaults to **127.0.0.1** — the same
loopback-first posture as the actor-worker transport: the body is
read-only telemetry (no pickle, no RCE), but ``/flightz`` carries
exception messages and traceback tails, so exposing it off-host is an
explicit ``ZOO_METRICS_HOST=0.0.0.0`` decision (node-exporter-style
scraping across a pod), not a silent default.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from analytics_zoo_tpu_torch.metrics.exporters import prometheus_text, snapshot
from analytics_zoo_tpu_torch.metrics.registry import MetricsRegistry

__all__ = ["MetricsServer", "maybe_start_from_env"]


class _Handler(BaseHTTPRequestHandler):
    # set per-server via type(); BaseHTTPRequestHandler instantiates one
    # handler per request
    server_ref: "MetricsServer" = None  # type: ignore[assignment]

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler contract)
        try:
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            route = self.server_ref._routes.get(path)
            if route is None:
                self._reply(404, "application/json", json.dumps(
                    {"error": "not found",
                     "endpoints": sorted(self.server_ref._routes)}))
                return
            status, ctype, body = route()
            self._reply(status, ctype, body)
        except BrokenPipeError:
            pass
        except Exception as e:  # a scrape must never kill the process
            try:
                self._reply(500, "application/json",
                            json.dumps({"error": repr(e)}))
            except Exception:
                pass

    def _reply(self, status: int, ctype: str, body: str):
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):
        pass  # scrapes every few seconds must not spam stderr


class MetricsServer:
    """Serve this process's registry/tracer/health/flight over HTTP."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: MetricsRegistry | None = None, tracer=None,
                 health=None, flight=None, aggregator=None):
        self._want_port = int(port)
        self._host = host
        self._registry = registry
        self._tracer = tracer
        self._health = health
        self._flight = flight
        self.aggregator = aggregator
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._routes = {
            "/metrics": self._metrics,
            "/varz": self._varz,
            "/trace": self._trace,
            "/healthz": self._healthz,
            "/flightz": self._flightz,
            "/telemetryz": self._telemetryz,
            "/alertz": self._alertz,
            "/": self._index,
        }

    # -- lazy component resolution (the process-global defaults are
    # created on first use; a server built before them must serve them)
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from analytics_zoo_tpu_torch.metrics.registry import get_registry

        return get_registry()

    def _trc(self):
        if self._tracer is not None:
            return self._tracer
        from analytics_zoo_tpu_torch.metrics.tracing import get_tracer

        return get_tracer()

    def _hlt(self):
        if self._health is not None:
            return self._health
        from analytics_zoo_tpu_torch.metrics.health import get_health

        return get_health()

    def _flt(self):
        if self._flight is not None:
            return self._flight
        from analytics_zoo_tpu_torch.metrics.flight import get_flight_recorder

        return get_flight_recorder()

    # -- endpoints ------------------------------------------------------
    def _index(self):
        return 200, "application/json", json.dumps(
            {"endpoints": sorted(p for p in self._routes if p != "/")})

    def _metrics(self):
        if self.aggregator is None:
            text = prometheus_text(self._reg())
        else:
            # own + per-source series through ONE renderer: a family
            # name present on both sides must produce ONE group with ONE
            # TYPE line, or the scraper rejects the whole body
            from analytics_zoo_tpu_torch.metrics.merge import (
                registry_samples,
                samples_to_prometheus,
            )

            text = samples_to_prometheus(
                registry_samples(self._reg())
                + self.aggregator.labeled_samples())
        return 200, "text/plain; version=0.0.4", text

    def _varz(self):
        tracer = self._trc()
        doc = snapshot(self._reg())
        doc["health"] = self._hlt().status()
        doc["trace"] = {"dropped_spans": tracer.dropped,
                        "max_events": tracer.max_events}
        flight = self._flt()
        doc["flight"] = {"events": len(flight.events()),
                         "dropped": flight.dropped}
        # Autotune decision log (feature/autotune.py): consult
        # sys.modules only — a process that never turned the controller
        # on must not import the feature package from a scrape.
        import sys

        auto = sys.modules.get("analytics_zoo_tpu_torch.feature.autotune")
        if auto is not None:
            doc["autotune"] = auto.varz_doc()
        # Fleet panel (serving/fleet.py): replica/scaler state + scale
        # decision log — same sys.modules-only contract.
        fleet = sys.modules.get("analytics_zoo_tpu_torch.serving.fleet")
        if fleet is not None:
            doc["fleet"] = fleet.varz_doc()
        # Router panel (serving/router.py): per-model fleet state +
        # the prime/scale/stop decision log — same contract.
        router = sys.modules.get("analytics_zoo_tpu_torch.serving.router")
        if router is not None:
            doc["router"] = router.varz_doc()
        # Admission panel (serving/admission.py): per-stream verdicts +
        # the accept/shed transition log — same contract.
        admission = sys.modules.get(
            "analytics_zoo_tpu_torch.serving.admission")
        if admission is not None:
            doc["admission"] = admission.varz_doc()
        # Oracle panel (analysis/oracle.py): peak table, residual-fit
        # size and the predicted-vs-measured pairs per config.
        oracle = sys.modules.get("analytics_zoo_tpu_torch.analysis.oracle")
        if oracle is not None:
            doc["oracle"] = oracle.varz_doc()
        # Elastic panel (elastic/supervisor.py): generation/world/member
        # state + the rejoin decision log — same sys.modules-only
        # contract.
        elastic = sys.modules.get("analytics_zoo_tpu_torch.elastic.supervisor")
        if elastic is not None:
            doc["elastic"] = elastic.varz_doc()
        # SLO panel (metrics/slo.py): specs + alert state + the
        # firing/resolved decision log — same sys.modules-only contract.
        slo = sys.modules.get("analytics_zoo_tpu_torch.metrics.slo")
        if slo is not None:
            doc["slo"] = slo.varz_doc()
        # Scraper panel (metrics/scrape.py): per-target fetch/staleness.
        scrape = sys.modules.get("analytics_zoo_tpu_torch.metrics.scrape")
        if scrape is not None:
            doc["scrape"] = scrape.varz_doc()
        if self.aggregator is not None:
            agg = self.aggregator.merged(include_driver=False)
            doc["aggregate"] = {"sources": agg["sources"],
                                "totals": agg["totals"]}
        return 200, "application/json", json.dumps(doc)

    def _trace(self):
        return 200, "application/json", json.dumps(
            self._trc().to_chrome_trace())

    def _healthz(self):
        status = self._hlt().status()
        code = 200 if status["healthy"] else 503
        return code, "application/json", json.dumps(status)

    def _flightz(self):
        return 200, "application/json", json.dumps(
            self._flt().to_doc(reason="live"))

    def _telemetryz(self):
        from analytics_zoo_tpu_torch.metrics.merge import telemetry_snapshot

        return 200, "application/json", json.dumps(
            telemetry_snapshot(self._reg(), health=self._hlt()))

    def _alertz(self):
        # sys.modules-only, like the /varz panels: serving /alertz on a
        # process with no SLO engine must not import the module.
        import sys
        import time

        slo = sys.modules.get("analytics_zoo_tpu_torch.metrics.slo")
        if slo is None:
            doc = {"ts": time.time(), "engines": 0, "firing": [],
                   "alerts": []}
        else:
            doc = slo.alertz_doc()
        return 200, "application/json", json.dumps(doc)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        handler = type("BoundHandler", (_Handler,), {"server_ref": self})
        self._httpd = ThreadingHTTPServer(
            (self._host, self._want_port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="zoo-metrics-http")
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        """The BOUND port (resolves ``port=0`` after :meth:`start`)."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._want_port

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self._host in ("0.0.0.0", "") else self._host
        return f"http://{host}:{self.port}"

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd, self._thread = None, None


# ---------------------------------------------------------------------------
# Env opt-in: one process-wide server, started by whichever production
# loop (serving, fit) reaches it first.
# ---------------------------------------------------------------------------

_env_server: MetricsServer | None = None  # guarded-by: _env_lock
_env_lock = threading.Lock()


def maybe_start_from_env(aggregator=None) -> MetricsServer | None:
    """Start the process's scrape server iff ``ZOO_METRICS_PORT`` is set
    (idempotent — later callers get the same instance; an ``aggregator``
    passed by a later caller is attached if none was).  Returns None when
    the env does not opt in or the port cannot be bound (a telemetry
    endpoint must never take the training/serving loop down)."""
    import logging
    import os

    global _env_server
    port = os.environ.get("ZOO_METRICS_PORT")
    if not port:
        return None
    with _env_lock:
        if _env_server is not None:
            if aggregator is not None and _env_server.aggregator is None:
                _env_server.aggregator = aggregator
            return _env_server
        try:
            srv = MetricsServer(
                port=int(port),
                host=os.environ.get("ZOO_METRICS_HOST", "127.0.0.1"),
                aggregator=aggregator).start()
        except (OSError, ValueError) as e:
            logging.getLogger("analytics_zoo_tpu_torch").warning(
                "metrics server not started (ZOO_METRICS_PORT=%s): %s",
                port, e)
            return None
        _env_server = srv
        logging.getLogger("analytics_zoo_tpu_torch").info(
            "metrics server on %s (/metrics /varz /trace /healthz "
            "/flightz /telemetryz /alertz)", srv.url)
        return srv
