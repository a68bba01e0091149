"""VarzScraper — the federation tier's pull loop (counterpart of
``analytics_zoo_tpu/metrics/scrape.py``).

A daemon thread polls a target set (static list, ``ZOO_SCRAPE_TARGETS``,
or a discovery callable over fleet/elastic broker records) and pulls
each host's ``/telemetryz`` (the MERGEABLE snapshot: histogram samples
keep bucket vectors), falling back to ``/varz`` when the target predates
the route — the fallback keeps counters/gauges and drops histogram
summaries, which cannot be merged.  Every successful pull feeds:

- the :class:`~analytics_zoo_tpu_torch.metrics.merge.TelemetryAggregator`
  (current merged values, ``/metrics`` + ``/varz aggregate`` on the
  driver), and
- an optional :class:`~analytics_zoo_tpu_torch.metrics.timeseries.
  TimeSeriesStore` (windowed history — what the federated scaler and
  the SLO engine query), labeled per target.

Failure visibility is the point: per-target staleness gauges and
fetch-error counters (``zoo_scrape_*``), a ``scrape:<target>``
component heartbeat in the local :class:`HealthRegistry` (so the
driver's /healthz goes 503 when any target goes dark past its stale
threshold — the merged verdict), and the aggregator's ``stale``
flagging keep a dead host visible in every rollup instead of silently
vanishing from it.

An attached :class:`~analytics_zoo_tpu_torch.metrics.slo.SloEngine` is
evaluated once per poll cycle — the scraper is the natural tick source
for federation-level SLOs (its own staleness gauge feeds the stock
``worker_heartbeat`` spec).

Locking: ``_lock`` guards only target bookkeeping; it is NEVER held
across an HTTP fetch, a broker call, or an aggregator/store/engine
ingest.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
import weakref

from analytics_zoo_tpu_torch.metrics.health import get_health
from analytics_zoo_tpu_torch.metrics.runtime import ScrapeMetrics

__all__ = ["VarzScraper", "normalize_target", "targets_from_env",
           "fleet_varz_targets", "elastic_varz_targets", "varz_doc",
           "VARZ_KEY_PREFIX"]

# Broker hash key prefix under which processes publish their metrics
# URL for discovery (fleet replicas with --metrics-port, elastic
# workers with ZOO_METRICS_PORT): key = prefix + owner/worker id,
# fields {"url": ..., "ts": ...}.  One key PER process — a shared hash
# would reintroduce the FileBroker read-modify-write race the roster
# redesign removed.
VARZ_KEY_PREFIX = "__zoo-varz-"

_active: "weakref.WeakSet[VarzScraper]" = weakref.WeakSet()
_active_lock = threading.Lock()


def fget(mapping, key, default=None):
    """Broker-hash field access that tolerates the redis transport's
    bytes keys/values (FileBroker/InMemoryBroker return str); the port's
    copy of ``analytics_zoo_tpu/elastic/membership.py``'s ``fget``."""
    if not mapping:
        return default
    val = mapping.get(key, mapping.get(
        key.encode() if isinstance(key, str) else key, default))
    if isinstance(val, bytes):
        val = val.decode()
    return val


def normalize_target(target) -> tuple[str, str]:
    """``(name, base_url)`` from ``host:port``, a full URL, or a
    ``(name, url)`` pair.  Trailing path components (``/varz``) are
    stripped — the scraper owns route selection."""
    if isinstance(target, (tuple, list)) and len(target) == 2:
        name, url = str(target[0]), str(target[1])
    else:
        name = url = str(target).strip()
    if not url.startswith(("http://", "https://")):
        url = "http://" + url
    scheme, rest = url.split("://", 1)
    hostport = rest.split("/", 1)[0]
    base = f"{scheme}://{hostport}"
    if name == url or not name:
        name = hostport
    return name, base


def targets_from_env(env: dict | None = None) -> list[tuple[str, str]]:
    """Parse ``ZOO_SCRAPE_TARGETS`` (comma/space separated
    ``host:port`` or URLs) into normalized pairs."""
    import os

    raw = (env if env is not None else os.environ).get(
        "ZOO_SCRAPE_TARGETS", "")
    out = []
    for part in raw.replace(",", " ").split():
        out.append(normalize_target(part))
    return out


def fleet_varz_targets(broker, prefix: str = VARZ_KEY_PREFIX):
    """Discovery callable over broker-published metrics URLs: every
    process that started a metrics server and registered it under
    ``prefix + <owner>`` (fleet replicas via ``--metrics-port``).
    Returns ``{owner: url}``; tolerant of redis byte values."""
    def discover() -> dict:
        out = {}
        try:
            keys = broker.keys(prefix)
        except Exception:
            return out
        for key in keys:
            k = key.decode() if isinstance(key, bytes) else str(key)
            url = fget(broker.hgetall(k), "url")
            if url:
                out[k[len(prefix):]] = url
        return out

    return discover


def elastic_varz_targets(broker, prefix: str):
    """Discovery over elastic membership heartbeats.  The reference reads
    its ``MembershipLedger``; the port's elastic runtime is not there
    yet, so this raises."""
    raise NotImplementedError(
        "elastic_varz_targets reads the elastic runtime's membership "
        "ledger, which the port does not have yet (ROADMAP queue 1 item "
        "21); use fleet_varz_targets or static targets")


class _Target:
    __slots__ = ("name", "url", "static", "last_ok", "last_err",
                 "errors", "fetches", "remote_healthy")

    def __init__(self, name: str, url: str, static: bool):
        self.name = name
        self.url = url
        self.static = static
        self.last_ok: float | None = None
        self.last_err: str | None = None
        self.errors = 0
        self.fetches = 0
        self.remote_healthy: bool | None = None


class VarzScraper:
    """Cross-host telemetry poller feeding aggregator + store + SLOs."""

    def __init__(self, targets=(), aggregator=None, store=None,
                 engine=None, interval: float = 1.0,
                 stale_after: float | None = None, timeout: float = 2.0,
                 registry=None, health=None, discover=None,
                 source_label: str = "host", clock=time.time):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.aggregator = aggregator
        self.store = store
        self.engine = engine
        self.interval = float(interval)
        # default: a target is stale after missing ~3 polls
        self.stale_after = (float(stale_after) if stale_after is not None
                            else 3.0 * self.interval)
        self.timeout = float(timeout)
        self.source_label = source_label
        self.metrics = ScrapeMetrics(registry)
        self._health = health if health is not None else get_health()
        self._discover = discover
        self._clock = clock
        self._lock = threading.Lock()
        self._targets: dict[str, _Target] = {}  # guarded-by: _lock
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._stop = threading.Event()  # guarded-by: _lock
        for t in targets:
            self.add_target(t)
        for t in targets_from_env():
            self.add_target(t)
        with _active_lock:
            _active.add(self)

    # -- target set -----------------------------------------------------
    def add_target(self, target, static: bool = True):
        """Add a target once; a target added again (discovery returns
        every live key each poll) changes nothing.  The reference
        registers its health component on every call, which beats it:
        a discovered target that died (its broker key outlives a SIGKILL)
        then never goes stale in ``/healthz``.  The port registers the
        component when the target is new, so its silence shows."""
        name, url = normalize_target(target)
        with self._lock:
            new = name not in self._targets
            if new:
                self._targets[name] = _Target(name, url, static)
        if new:
            # component registration outside our lock (health has its own)
            self._health.register(f"scrape:{name}",
                                  stale_after=self.stale_after)

    def remove_target(self, name: str):
        with self._lock:
            self._targets.pop(name, None)
        self._health.unregister(f"scrape:{name}")

    def targets(self) -> list[str]:
        with self._lock:
            return sorted(self._targets)

    def _merge_discovered(self):
        if self._discover is None:
            return
        try:
            found = self._discover()
        except Exception:
            return
        pairs = (found.items() if isinstance(found, dict)
                 else [(None, t) for t in found])
        for name, url in pairs:
            self.add_target((name, url) if name else url, static=False)

    # -- one pull -------------------------------------------------------
    def _fetch(self, base: str) -> dict:
        """GET the mergeable snapshot; fall back to /varz (counters and
        gauges only — summary-format histograms cannot be merged) for
        targets predating the /telemetryz route."""
        try:
            with urllib.request.urlopen(base + "/telemetryz",
                                        timeout=self.timeout) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
        with urllib.request.urlopen(base + "/varz",
                                    timeout=self.timeout) as r:
            doc = json.loads(r.read().decode())
        samples = [s for s in doc.get("samples", ())
                   if s.get("kind") in ("counter", "gauge")]
        return {"ts": doc.get("ts"), "health": doc.get("health"),
                "samples": samples}

    def poll_once(self) -> int:
        """One full cycle: discovery, every target pulled, staleness
        gauges refreshed, attached SLO engine ticked.  Returns the
        number of successful pulls.  Public so tests and synchronous
        callers can drive the scraper without the thread."""
        self._merge_discovered()
        with self._lock:
            targets = list(self._targets.values())
        now = self._clock()
        ok = 0
        for tgt in targets:
            t0 = time.perf_counter()
            try:
                snap = self._fetch(tgt.url)
            except Exception as e:
                tgt.errors += 1
                tgt.last_err = repr(e)
                if self.metrics.enabled:
                    self.metrics.errors.labels(target=tgt.name).inc()
            else:
                ok += 1
                tgt.fetches += 1
                tgt.last_ok = now
                tgt.last_err = None
                health = snap.get("health") or {}
                tgt.remote_healthy = bool(health.get("healthy", True))
                self._ingest(tgt, snap, now)
                if self.metrics.enabled:
                    self.metrics.fetches.labels(target=tgt.name).inc()
                    self.metrics.fetch_seconds.observe(
                        time.perf_counter() - t0)
            self._update_verdict(tgt, now)
        if self.metrics.enabled:
            self.metrics.targets.set(len(targets))
        if self.engine is not None:
            self.engine.evaluate(now=now)
        return ok

    def _ingest(self, tgt: _Target, snap: dict, now: float):
        source = {self.source_label: tgt.name}
        if self.aggregator is not None:
            self.aggregator.ingest(snap, **source)
        if self.store is not None:
            self.store.ingest(snap.get("samples", ()), ts=now,
                              source=source)

    def _update_verdict(self, tgt: _Target, now: float):
        age = (now - tgt.last_ok) if tgt.last_ok is not None \
            else float("inf")
        if self.metrics.enabled:
            self.metrics.staleness.labels(target=tgt.name).set(
                min(age, 1e9))
        # staleness series for the stock worker_heartbeat SLO: the
        # gauge above is per-process registry; the STORE feeds windows
        if self.store is not None:
            self.store.observe(
                "zoo_scrape_staleness_seconds", min(age, 1e9),
                labels={"target": tgt.name}, ts=now)
        comp = f"scrape:{tgt.name}"
        fresh = age <= self.stale_after
        if fresh and tgt.remote_healthy is not False:
            self._health.heartbeat(comp)
        elif fresh and tgt.remote_healthy is False:
            # target answers but reports itself unhealthy: propagate
            self._health.set_status(comp, False)

    # -- merged verdict -------------------------------------------------
    def healthz(self) -> dict:
        """The federation-level health rollup: healthy iff every target
        is fresh AND reports itself healthy."""
        now = self._clock()
        with self._lock:
            targets = list(self._targets.values())
        out = {}
        healthy = True
        for tgt in targets:
            age = (now - tgt.last_ok) if tgt.last_ok is not None \
                else None
            t_ok = (age is not None and age <= self.stale_after
                    and tgt.remote_healthy is not False)
            healthy = healthy and t_ok
            out[tgt.name] = {
                "url": tgt.url, "healthy": t_ok,
                "age_seconds": age, "fetches": tgt.fetches,
                "errors": tgt.errors, "last_error": tgt.last_err,
                "remote_healthy": tgt.remote_healthy,
                "static": tgt.static,
            }
        return {"healthy": healthy and bool(targets), "targets": out}

    def to_doc(self) -> dict:
        doc = self.healthz()
        doc["interval"] = self.interval
        doc["stale_after"] = self.stale_after
        return doc

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "VarzScraper":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="zoo-scrape")
            self._thread.start()
        return self

    def stop(self):
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5)

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                # the poll loop must survive anything a target throws
                pass
            self._stop.wait(self.interval)


def varz_doc() -> list[dict]:
    """Docs for every live scraper — the /varz ``scrape`` panel."""
    with _active_lock:
        scrapers = list(_active)
    return [s.to_doc() for s in scrapers]
