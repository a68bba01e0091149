"""Multi-replica serving fleet with SLO-aware autoscaling (counterpart of
``analytics_zoo_tpu/serving/fleet.py``).

The ROADMAP's "millions of users" serving shape: N
:class:`~analytics_zoo_tpu_torch.serving.server.ClusterServing` replicas
against ONE broker, coordinated by nothing but the broker's
exactly-once work-claim protocol (``Broker.claim``/``extend``/
``release`` — per-record leases, so replicas never double-serve and a
dead replica's claimed-but-unserved records are re-claimed by survivors
after lease expiry), each running per-bucket continuous batching in its
reader stage.  :class:`FleetController` supervises the replicas and
ticks an :class:`~analytics_zoo_tpu_torch.serving.scaler.SloScaler` over
rolling-window telemetry deltas (the zootune pattern): predict p99 from
``zoo_serving_predict_seconds``, service rate from
``zoo_serving_records_total``, unclaimed backlog and memory pressure
from the broker — scaling up on sustained SLO violation and down on
sustained slack.

New replicas warm-start: thread replicas given one shared
``InferenceModel`` replay the captures its first requests made (one
``CaptureGroup``, whose lock serializes the replays: N thread replicas
overlap host work — claim, decode, write-back — not device work), and a
process replica loads the kernel libraries already built in
``build/kernels/`` (or ``ZOO_COMPILE_CACHE``) as hits under
``kernel_<name>`` and captures its own buckets, so no replica runs nvcc.

Two replica modes:

- ``mode="thread"`` (default): replicas are daemon threads in this
  process sharing the registry — full scaler signals, the bench shape.
  Works over any broker, including :class:`InMemoryBroker`.
- ``mode="process"``: replicas are subprocesses running ``python -m
  analytics_zoo_tpu_torch.serving.fleet --replica`` against a cross-process
  broker (``dir:``/redis spec).  Kill-resilient (the lease-expiry test
  shape); scaler signals are backlog-driven — unclaimed depth plus its
  observed drain rate stand in for the replicas' predict histograms —
  until the telemetry merge plane is pointed at their /varz endpoints.

Every scale decision lands three ways (the autotune convention): the
``zoo_fleet_*`` metric family, a ``fleet_scale`` flight-recorder event,
and a bounded structured decision log served in the ``fleet`` section
of ``/varz`` (rendered as a table by ``tools/metrics_dump.py``).
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import threading
import time
import weakref
from collections import deque

from ..metrics import FleetMetrics, ServingMetrics, get_flight_recorder, \
    get_registry
from .broker import connect_broker
from .client import INPUT_STREAM
from .scaler import FleetSignals, SloScaler
from .server import ClusterServing, ClusterServingHelper

__all__ = ["FleetController", "varz_doc"]

logger = logging.getLogger("analytics_zoo_tpu_torch")

# ---------------------------------------------------------------------------
# Live-controller registry for /varz (metrics/http.py consults
# sys.modules only — a scrape-only process never imports this module).
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: "weakref.WeakSet[FleetController]" = (  # guarded-by: _active_lock
    weakref.WeakSet())


def varz_doc() -> dict:
    """The ``fleet`` section of ``/varz``: every live controller's
    replica/scaler state plus the merged, time-ordered decision log."""
    with _active_lock:
        ctrls = list(_active)
    docs = [c.to_doc() for c in ctrls]
    decisions = sorted((d for doc in docs for d in doc["decisions"]),
                       key=lambda d: d["ts"])
    return {"controllers": docs, "decisions": decisions}


# ---------------------------------------------------------------------------
# Replica handles
# ---------------------------------------------------------------------------


class _ThreadReplica:
    """One in-process replica: a ClusterServing on its daemon thread."""

    kind = "thread"

    def __init__(self, owner: str, server: ClusterServing):
        self.owner = owner
        self.server = server

    def alive(self) -> bool:
        t = self.server._thread
        return t is not None and t.is_alive()

    def stop(self) -> None:
        self.server.stop()


class _ProcessReplica:
    """One subprocess replica (``python -m ...serving.fleet --replica``).

    SIGTERM asks for the clean shutdown (claims requeued with
    ``done=False``); SIGKILL after a grace period — and an actual
    ``kill -9`` from outside is exactly the lease-expiry story."""

    kind = "process"

    def __init__(self, owner: str, proc: subprocess.Popen):
        self.owner = owner
        self.proc = proc

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self) -> None:
        if self.proc.poll() is not None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5.0)


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


class FleetController:
    """Supervise N serving replicas + tick the SLO scaler.

    ``model_factory`` is called once per THREAD replica (return a shared
    pooled model to share executables, or a fresh one per replica);
    process replicas load ``helper.model_path`` themselves.  The
    controller never holds its lock across replica/broker calls
    (lock-order hygiene — the autotune ``_apply`` pattern).
    """

    def __init__(self, helper: ClusterServingHelper, broker,
                 model_factory=None, scaler: SloScaler | None = None,
                 interval: float = 1.0, mode: str = "thread",
                 serve_log: str | None = None, broker_spec=None,
                 registry=None, log_capacity: int = 256,
                 replica_extra_args=(), signal_source=None,
                 replica_metrics: bool = False,
                 stream: str = INPUT_STREAM, trim: bool = True):
        if mode not in ("thread", "process"):
            raise ValueError(f"mode must be thread|process, got {mode!r}")
        self.helper = helper
        self.db = connect_broker(broker)
        self.model_factory = model_factory
        self.scaler = scaler if scaler is not None else SloScaler()
        self.interval = float(interval)
        self.mode = mode
        self.serve_log = serve_log
        # process replicas need a SPEC they can re-connect from;
        # an InMemoryBroker instance cannot cross a process boundary
        self.broker_spec = broker_spec if broker_spec is not None \
            else (broker if isinstance(broker, str) else None)
        if mode == "process" and not self.broker_spec:
            raise ValueError(
                "mode='process' needs a cross-process broker spec "
                "(dir:<spool> or host:port), not a live broker object")
        self.replica_extra_args = tuple(replica_extra_args)
        # Federation tier: when a signal source is attached
        # (FederatedSignalSource over a VarzScraper-fed store) the
        # scaler runs ONLY on the scraped cross-host view — the local
        # registry window is not consulted — and the decision gains a
        # host-count output.  Process replicas then need
        # ``replica_metrics=True`` so each exports /telemetryz and
        # publishes its URL for scraper discovery.
        self.signal_source = signal_source
        self.replica_metrics = bool(replica_metrics)
        # multi-tenant routing: one controller serves ONE
        # stream; a ModelRouter runs a controller per model stream.
        # trim=False for admission-guarded streams — overload is shed
        # at the front door, accepted records are never dropped.
        self.stream = str(stream)
        self.trim = bool(trim)
        self.metrics = FleetMetrics(registry=registry)
        # scaler signal sources: the SAME registry children the serving
        # replicas record into (thread mode) — family names resolve to
        # shared children
        reg = registry if registry is not None else get_registry()
        self._serving = ServingMetrics(registry=reg)

        self._lock = threading.Lock()
        self._replicas: list = []  # guarded-by: _lock
        # oracle-primed fleets START at the scaler's seeded prior
        # (initial_target == min_replicas when no prior was given)
        self._target = self.scaler.initial_target()  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._decisions: deque = (  # guarded-by: _lock
            deque(maxlen=int(log_capacity)))
        self._last_signals: FleetSignals = FleetSignals()  # guarded-by: _lock
        self._predict_base = None  # guarded-by: _lock
        self._records_base: float | None = None  # guarded-by: _lock
        self._window_t0: float | None = None  # guarded-by: _lock
        self._prev_depth: int | None = None  # guarded-by: _lock
        self._hosts: int | None = None  # guarded-by: _lock
        self._hosts_target: int | None = None  # guarded-by: _lock
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._flight = get_flight_recorder()
        self._owner_prefix = "%s-%d" % (socket.gethostname(), os.getpid())
        self.metrics.replicas_target.set(self._target)
        with _active_lock:
            _active.add(self)

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg, helper, broker, **kwargs):
        """Build controller + scaler from a
        :class:`~analytics_zoo_tpu_torch.common.engine.ZooConfig` (the
        ``ZOO_FLEET_*`` / ``ZOO_SLO_P99_MS`` env tier)."""
        scaler = kwargs.pop("scaler", None) or SloScaler(
            slo_p99_ms=cfg.slo_p99_ms,
            min_replicas=cfg.fleet_min_replicas,
            max_replicas=cfg.fleet_max_replicas)
        return cls(helper, broker, scaler=scaler,
                   interval=cfg.fleet_interval, **kwargs)

    # ------------------------------------------------------------------
    # replica lifecycle
    # ------------------------------------------------------------------
    def _next_owner(self) -> str:
        with self._lock:
            self._seq += 1
            return "%s-r%d" % (self._owner_prefix, self._seq)

    def _spawn(self):
        owner = self._next_owner()
        if self.mode == "thread":
            model = self.model_factory() if self.model_factory is not None \
                else self.helper.load_inference_model()
            srv = ClusterServing(helper=self.helper, model=model,
                                 broker=self.db, owner=owner,
                                 serve_log=self.serve_log,
                                 stream=self.stream, trim=self.trim)
            srv.start()
            rep = _ThreadReplica(owner, srv)
        else:
            cmd = [sys.executable, "-m",
                   "analytics_zoo_tpu_torch.serving.fleet", "--replica",
                   "--broker", str(self.broker_spec),
                   "--owner", owner,
                   "--batch-size", str(self.helper.batch_size),
                   "--budget-ms", str(self.helper.batch_budget_ms),
                   "--lease-ms", str(self.helper.lease_ms),
                   "--stream", self.stream]
            if not self.trim:
                cmd += ["--no-trim"]
            if self.helper.model_path:
                cmd += ["--model", str(self.helper.model_path)]
            if self.serve_log:
                cmd += ["--serve-log", self.serve_log]
            if self.replica_metrics:
                # ephemeral port; the replica publishes its bound URL
                # on the broker (VARZ_KEY_PREFIX) for scraper discovery
                cmd += ["--metrics-port", "0"]
            cmd += list(self.replica_extra_args)
            rep = _ProcessReplica(owner, subprocess.Popen(cmd))
        with self._lock:
            self._replicas.append(rep)
            n = len(self._replicas)
        self.metrics.replicas.set(n)
        return rep

    def _stop_one(self):
        """Retire the NEWEST replica (LIFO): its clean shutdown requeues
        any in-flight claims with ``done=False`` — no lease wait."""
        with self._lock:
            rep = self._replicas.pop() if self._replicas else None
            n = len(self._replicas)
        if rep is not None:
            rep.stop()
            self.metrics.replicas.set(n)

    def replica_count(self) -> int:
        with self._lock:
            return len(self._replicas)

    def owners(self) -> list:
        with self._lock:
            return [r.owner for r in self._replicas]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "FleetController":
        """Spawn up to the scaler's initial target (the oracle-seeded
        prior when one exists, else ``min_replicas``) and start the
        control loop (idempotent)."""
        initial = self.scaler.initial_target()
        primed = initial > self.scaler.min_replicas \
            and self.replica_count() < initial
        while self.replica_count() < initial:
            self._spawn()
        if primed:
            self._record_decision(
                "prime", self.scaler.min_replicas, initial,
                "oracle_prior", None, 0)
        self._stop_evt.clear()
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="zoo-fleet")
            t = self._thread
        t.start()
        return self

    def stop(self) -> None:
        """Stop the control loop, then every replica (clean shutdown:
        in-flight claims are requeued, results flushed)."""
        self._stop_evt.set()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        while True:
            with self._lock:
                rep = self._replicas.pop() if self._replicas else None
            if rep is None:
                break
            rep.stop()
        self.metrics.replicas.set(0)

    def _run(self):
        while not self._stop_evt.wait(self.interval):
            try:
                self._tick()
            except Exception as e:
                # the controller must never take the fleet down; a
                # policy bug shows in the flight ring, not a crash
                self._flight.record_exception(e, where="fleet")

    # ------------------------------------------------------------------
    # one control window
    # ------------------------------------------------------------------
    def _gather_window(self) -> FleetSignals:
        if self.signal_source is not None:
            return self._gather_federated()
        now = time.monotonic()
        with self._lock:
            p_base = self._predict_base
            r_base = self._records_base
            t0 = self._window_t0
            prev_depth = self._prev_depth
        hist = self._serving.predict_latency
        delta = hist.delta_since(p_base)
        records = self._serving.records.get()
        new_p_base = hist.snapshot_state()
        depth = int(self.db.unclaimed(self.stream))
        rate = 0.0
        if r_base is not None and t0 is not None and now > t0:
            rate = max(0.0, records - r_base) / (now - t0)
            if rate == 0.0 and not delta.get("count") \
                    and prev_depth is not None:
                # process-mode replicas record into THEIR registries,
                # not ours — fall back to the observable backlog drain
                # rate so a healthily-draining fleet is not mistaken
                # for a stalled one (est=inf) and scaled to max
                rate = max(0.0, prev_depth - depth) / (now - t0)
        with self._lock:
            self._predict_base = new_p_base
            self._records_base = records
            self._window_t0 = now
            self._prev_depth = depth
        sig = FleetSignals(
            predict_p99_s=float(delta.get("p99", 0.0) or 0.0),
            window_count=int(delta.get("count", 0) or 0),
            service_rate=rate,
            queue_depth=depth,
            memory_ratio=float(self.db.memory_ratio()),
        )
        if p_base is None:
            # first window: baseline only, report an idle signal
            sig = FleetSignals(queue_depth=sig.queue_depth,
                               memory_ratio=sig.memory_ratio)
        return sig

    def _gather_federated(self) -> FleetSignals:
        """Federated window: the LOCAL registry is not consulted — the
        signal source reads the scraped per-host series.
        The window spans the elapsed time since the previous tick, so
        the store's delta covers exactly one control interval."""
        now = time.monotonic()
        with self._lock:
            t0 = self._window_t0
            self._window_t0 = now
        window_s = max(self.interval,
                       (now - t0) if t0 is not None else self.interval)
        return self.signal_source.gather(window_s)

    def _supervise(self) -> int:
        """Drop dead replicas (their leases expire to survivors) and
        respawn to target; returns live count."""
        with self._lock:
            dead = [r for r in self._replicas if not r.alive()]
            for r in dead:
                self._replicas.remove(r)
            n, target = len(self._replicas), self._target
        if dead:
            self.metrics.replica_deaths.inc(len(dead))
            self.metrics.replicas.set(n)
            for r in dead:
                self._flight.record("fleet_replica_death", owner=r.owner)
                logger.warning("fleet: replica %s died; records it "
                               "claimed re-serve after lease expiry",
                               r.owner)
        while n < target and not self._stop_evt.is_set():
            self._spawn()
            self._record_decision("replace", n, n + 1, "supervision",
                                  None, 0)
            n += 1
        return n

    def _tick(self):
        n = self._supervise()
        sig = self._gather_window()
        est = self.scaler.estimate_p99_s(sig)
        if est != float("inf"):
            # inf (stalled backlog) would be JSON-hostile in /varz and
            # misleading as 0 — the decision log carries the event
            self.metrics.est_p99.set(est)
        self.metrics.queue_depth.set(sig.queue_depth)
        if est > self.scaler.slo_p99_ms / 1e3:
            self.metrics.slo_violations.inc()
        hosts = hosts_target = None
        if self.signal_source is not None:
            hosts = max(1, int(self.signal_source.host_count()))
            target, hosts_target, reason = self.scaler.decide_fleet(
                n, hosts, sig)
            self.metrics.hosts.set(hosts)
            self.metrics.hosts_target.set(hosts_target)
        else:
            target, reason = self.scaler.decide(n, sig)
        with self._lock:
            self._target = target
            self._last_signals = sig
            self._hosts = hosts
            self._hosts_target = hosts_target
        self.metrics.replicas_target.set(target)
        if target == n:
            return
        action = "up" if target > n else "down"
        self._record_decision(action, n, target, reason, est,
                              sig.queue_depth, hosts=hosts,
                              hosts_target=hosts_target)
        while n < target and not self._stop_evt.is_set():
            self._spawn()
            n += 1
        while n > target and not self._stop_evt.is_set():
            self._stop_one()
            n -= 1

    def _record_decision(self, action, old, new, reason, est_p99_s,
                         queue_depth, hosts=None, hosts_target=None):
        est_ms = None if est_p99_s is None or est_p99_s != est_p99_s \
            or est_p99_s == float("inf") else round(est_p99_s * 1e3, 3)
        row = {"ts": time.time(), "action": action, "old": old,
               "new": new, "reason": reason, "est_p99_ms": est_ms,
               "queue_depth": queue_depth}
        if hosts is not None:
            row["hosts"] = hosts
            row["hosts_target"] = hosts_target
        with self._lock:
            self._decisions.append(row)
        self.metrics.decisions.labels(action=action, reason=reason).inc()
        self._flight.record("fleet_scale", action=action, old=old,
                            new=new, reason=reason, est_p99_ms=est_ms,
                            queue_depth=queue_depth,
                            **({"hosts": hosts,
                                "hosts_target": hosts_target}
                               if hosts is not None else {}))

    # ------------------------------------------------------------------
    # introspection (/varz, metrics_dump, benches)
    # ------------------------------------------------------------------
    def decision_log(self) -> list:
        with self._lock:
            return list(self._decisions)

    def current(self) -> dict:
        with self._lock:
            sig = self._last_signals
            return {
                "replicas": len(self._replicas),
                "target": self._target,
                "owners": [r.owner for r in self._replicas],
                "mode": self.mode,
                "stream": self.stream,
                "federated": self.signal_source is not None,
                "hosts": self._hosts,
                "hosts_target": self._hosts_target,
                "slo_p99_ms": self.scaler.slo_p99_ms,
                "min_replicas": self.scaler.min_replicas,
                "max_replicas": self.scaler.max_replicas,
                "window": {
                    "predict_p99_ms": round(sig.predict_p99_s * 1e3, 3),
                    "service_rate": round(sig.service_rate, 3),
                    "queue_depth": sig.queue_depth,
                    "memory_ratio": round(sig.memory_ratio, 4),
                },
            }

    def to_doc(self) -> dict:
        return {"current": self.current(), "decisions": self.decision_log()}


# ---------------------------------------------------------------------------
# Subprocess replica entry point:
#   python -m analytics_zoo_tpu_torch.serving.fleet --replica --broker dir:...
# ---------------------------------------------------------------------------


class _SyntheticModel:
    """Load-test stand-in model: per-RECORD service time, GIL-releasing
    (time.sleep), fixed 5-logit output — the bench/kill-test workload
    when no real model path is given."""

    def __init__(self, sleep_ms_per_record: float, classes: int = 5):
        self.sleep_s = float(sleep_ms_per_record) / 1e3
        self.classes = int(classes)

    def predict(self, arr):
        import numpy as np

        if self.sleep_s > 0:
            time.sleep(self.sleep_s * int(arr.shape[0]))
        out = np.zeros((int(arr.shape[0]), self.classes), np.float32)
        out[:, 0] = 1.0
        return out


def _replica_gauges():
    """The collect hook of a replica's ``MetricsServer``: sets this
    process's ``zoo_kernel_invocations`` gauges
    (``parallel.plan.record_kernel_gauges``) and ``zoo_device_*`` gauges
    (``metrics.record_device_memory``; none without a CUDA device) as a
    scrape is served, so a scraper reads the launches and device memory
    of a replica as of its last scrape, a replica killed mid-batch
    included."""
    from ..metrics import record_device_memory
    from ..parallel.plan import data_parallel, record_kernel_gauges

    plan = data_parallel()

    def collect():
        record_kernel_gauges("serving", plan)
        record_device_memory()

    return collect


def _replica_main(argv) -> int:
    import argparse
    import signal

    p = argparse.ArgumentParser(
        prog="analytics_zoo_tpu_torch.serving.fleet",
        description="run ONE fleet replica against a shared broker")
    p.add_argument("--replica", action="store_true", required=True)
    p.add_argument("--broker", required=True,
                   help="cross-process broker spec (dir:<spool>, "
                        "host:port)")
    p.add_argument("--owner", default=None)
    p.add_argument("--model", default=None, help="model path; omit to "
                   "serve the synthetic sleep model")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--budget-ms", type=float, default=None)
    p.add_argument("--lease-ms", type=int, default=None)
    p.add_argument("--synthetic-sleep-ms", type=float, default=0.0,
                   help="per-record service time of the synthetic model")
    p.add_argument("--serve-log", default=None)
    p.add_argument("--stream", default=INPUT_STREAM,
                   help="input stream to claim from (per-model streams "
                        "under the router)")
    p.add_argument("--no-trim", action="store_true",
                   help="never trim the stream under broker pressure "
                        "(admission-guarded streams shed at the front "
                        "door instead)")
    p.add_argument("--idle-timeout", type=float, default=None)
    p.add_argument("--max-records", type=int, default=None)
    p.add_argument("--metrics-port", type=int, default=None,
                   help="start a /telemetryz server on this port (0 = "
                        "ephemeral) and publish its URL on the broker "
                        "for federation-scraper discovery")
    p.add_argument("--device", default=None,
                   help="device the model is loaded onto (default: the "
                        "card, 'cuda'; 'cpu' only when asked)")
    a = p.parse_args(argv)
    if a.model:
        from ..common.engine import init_zoo_context

        init_zoo_context(device=a.device)

    owner = a.owner or "%s-%d" % (socket.gethostname(), os.getpid())
    over = {"model_path": a.model, "batch_size": a.batch_size,
            "log_dir": os.environ.get("ZOO_SERVING_LOG_DIR", ".")}
    if a.budget_ms is not None:
        over["batch_budget_ms"] = a.budget_ms
    if a.lease_ms is not None:
        over["lease_ms"] = a.lease_ms
    helper = ClusterServingHelper(broker=a.broker, **over)
    model = None if a.model else _SyntheticModel(a.synthetic_sleep_ms)
    srv = ClusterServing(helper=helper, model=model, owner=owner,
                         serve_log=a.serve_log, stream=a.stream,
                         trim=not a.no_trim)
    metrics_srv, varz_db = None, None
    if a.metrics_port is not None:
        # federated replica: export this process's registry at
        # /telemetryz and register the bound URL under the discovery
        # key — the controller-side VarzScraper finds it there.  A bind
        # failure degrades to an undiscoverable (but serving) replica.
        from analytics_zoo_tpu_torch.metrics.http import MetricsServer
        from analytics_zoo_tpu_torch.metrics.scrape import VARZ_KEY_PREFIX

        try:
            metrics_srv = MetricsServer(port=a.metrics_port,
                                        collect=_replica_gauges()).start()
            varz_db = connect_broker(a.broker)
            varz_db.hset(VARZ_KEY_PREFIX + owner,
                         {"url": metrics_srv.url, "ts": str(time.time())})
        except OSError:
            metrics_srv = None
    signal.signal(signal.SIGTERM, lambda *_: srv.stop())
    try:
        srv.run(max_records=a.max_records, idle_timeout=a.idle_timeout)
    finally:
        if varz_db is not None:
            try:
                varz_db.delete(VARZ_KEY_PREFIX + owner)
            except Exception:
                pass  # a dying replica just leaves a stale key; the
                # scraper's staleness verdict handles it
        if metrics_srv is not None:
            metrics_srv.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    sys.exit(_replica_main(sys.argv[1:]))
