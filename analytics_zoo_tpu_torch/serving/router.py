"""Multi-tenant model routing over the shared broker (counterpart of
``analytics_zoo_tpu/serving/router.py``).

One :class:`ModelRouter` serves N models from ONE broker: each
:class:`~analytics_zoo_tpu_torch.serving.modelspec.ModelSpec` gets its own
input stream (:func:`~analytics_zoo_tpu_torch.serving.client.model_stream`),
its own :class:`~analytics_zoo_tpu_torch.serving.scaler.SloScaler`, and its own
:class:`~analytics_zoo_tpu_torch.serving.fleet.FleetController` — a
heterogeneous replica set in which every replica still speaks nothing
but the broker's exactly-once claim protocol, so per-record leases,
takeover on death, and the serve-log audit all hold per model.

Not ported yet: the reference's oracle-picked serving config
(``ConfigOracle.choose_serving``: replica prior, pad buckets, batch
budget), which waits for the config oracle (ROADMAP queue 1 item 19).
``oracle=`` raises; every tenant starts reactively at ``min_replicas``,
as the reference's does for a model without cost-model features.

With ``admission=True`` every model stream additionally gets an
:class:`~analytics_zoo_tpu_torch.serving.admission.AdmissionController`
(front-door shedding) and its fleet runs ``trim=False`` — accepted
work is never dropped.

Router state lands the standard three ways: the ``zoo_router_*`` /
``zoo_fleet_model_*`` metric families (per-model replica count,
backlog, estimated p99), ``router`` flight events on control actions,
and a bounded decision log in the ``router`` section of ``/varz``
(rendered by ``tools/metrics_dump.py``).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque

from ..metrics import RouterMetrics, get_flight_recorder
from .admission import AdmissionController
from .broker import connect_broker
from .client import model_stream
from .fleet import FleetController
from .modelspec import ModelSpec, parse_model_specs
from .scaler import FleetSignals, SloScaler
from .server import ClusterServingHelper

__all__ = ["ModelRouter", "varz_doc"]

# ---------------------------------------------------------------------------
# Live-router registry for /varz (metrics/http.py consults sys.modules
# only — a scrape-only process never imports this module).
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: "weakref.WeakSet[ModelRouter]" = (  # guarded-by: _active_lock
    weakref.WeakSet())


def varz_doc() -> dict:
    """The ``router`` section of ``/varz``: every live router's
    per-model state plus the merged, time-ordered decision log."""
    with _active_lock:
        routers = list(_active)
    docs = [r.to_doc() for r in routers]
    decisions = sorted((d for doc in docs for d in doc["decisions"]),
                       key=lambda d: d["ts"])
    return {"routers": docs, "decisions": decisions}


class _Tenant:
    """Per-model runtime bundle: spec + oracle verdict + scaler +
    fleet controller (+ optional admission controller)."""

    def __init__(self, spec: ModelSpec, verdict, controller,
                 admission):
        self.spec = spec
        self.verdict = verdict
        self.controller = controller
        self.admission = admission
        self.stream = controller.stream


class ModelRouter:
    """Run one serving fleet per routed model.

    ``specs`` is a list of :class:`ModelSpec` (or the raw
    ``ZOO_SERVING_MODELS`` string).  ``oracle`` raises
    ``NotImplementedError`` (ROADMAP queue 1 item 19), and ``features``
    (the reference's cost-model rows for the oracle) are kept but read by
    nothing: every model starts reactively at ``min_replicas``.
    ``model_factory(spec)`` builds the model a thread replica serves;
    ``helper_factory(spec, verdict)`` builds the per-model
    :class:`~analytics_zoo_tpu_torch.serving.server.ClusterServingHelper`
    (``verdict`` is None: no oracle picks one).
    """

    def __init__(self, broker, specs, model_factory=None,
                 helper_factory=None, oracle=None, features=None,
                 admission: bool = False, slo_engine=None,
                 min_replicas: int = 1, max_replicas: int = 8,
                 interval: float = 1.0,
                 fleet_interval: float | None = None,
                 mode: str = "thread", serve_log: str | None = None,
                 broker_spec=None, admission_kwargs=None,
                 controller_kwargs=None, registry=None,
                 log_capacity: int = 256):
        if oracle is not None:
            raise NotImplementedError(
                "ModelRouter(oracle=...): the config oracle's serving "
                "verdicts (replica prior, pad buckets, batch budget) are "
                "not ported yet (ROADMAP queue 1 item 19); omit it and "
                "every model starts reactively at min_replicas, as the "
                "reference's does for a model without features")
        if isinstance(specs, str):
            specs = parse_model_specs(specs)
        specs = list(specs)
        if not specs:
            raise ValueError("ModelRouter needs at least one ModelSpec")
        self.db = connect_broker(broker)
        self.specs = specs
        self.model_factory = model_factory
        self.helper_factory = helper_factory
        self.oracle = oracle
        self.features = dict(features or {})
        self.admission_enabled = bool(admission)
        self.slo_engine = slo_engine
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval = float(interval)
        self.fleet_interval = float(
            fleet_interval if fleet_interval is not None else interval)
        self.mode = mode
        self.serve_log = serve_log
        self.broker_spec = broker_spec
        self.admission_kwargs = dict(admission_kwargs or {})
        self.controller_kwargs = dict(controller_kwargs or {})
        self.metrics = RouterMetrics(registry=registry)
        self._flight = get_flight_recorder()
        self._lock = threading.Lock()
        self._tenants: dict = {}  # guarded-by: _lock
        self._decisions: deque = (  # guarded-by: _lock
            deque(maxlen=int(log_capacity)))
        self._prev_replicas: dict = {}  # guarded-by: _lock
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._stop_evt = threading.Event()
        with _active_lock:
            _active.add(self)

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg, broker, **kwargs):
        """Build from a :class:`~analytics_zoo_tpu_torch.common.engine
        .ZooConfig`: ``ZOO_SERVING_MODELS`` declares the tenants,
        ``ZOO_ADMISSION`` turns on front-door shedding, and the
        ``ZOO_FLEET_*`` tier bounds every per-model scaler."""
        specs = parse_model_specs(cfg.serving_models)
        kwargs.setdefault("admission", cfg.admission)
        kwargs.setdefault("min_replicas", cfg.fleet_min_replicas)
        kwargs.setdefault("max_replicas", cfg.fleet_max_replicas)
        kwargs.setdefault("interval", cfg.fleet_interval)
        return cls(broker, specs, **kwargs)

    # ------------------------------------------------------------------
    # per-model assembly
    # ------------------------------------------------------------------
    def _default_helper(self, spec: ModelSpec, verdict) -> \
            ClusterServingHelper:
        over = {}
        if self.broker_spec:
            over["broker"] = self.broker_spec
        return ClusterServingHelper(**over)

    def _build_tenant(self, spec: ModelSpec) -> _Tenant:
        name = spec.name
        verdict = None  # no config oracle in the port yet (item 19)
        scaler = SloScaler(
            slo_p99_ms=spec.slo_p99_ms,
            min_replicas=self.min_replicas,
            max_replicas=self.max_replicas)
        helper = (self.helper_factory(spec, verdict)
                  if self.helper_factory is not None
                  else self._default_helper(spec, verdict))
        factory = None
        if self.model_factory is not None:
            factory = lambda spec=spec: self.model_factory(spec)  # noqa: E731
        stream = model_stream(name)
        ctrl = FleetController(
            helper, self.db, model_factory=factory, scaler=scaler,
            interval=self.fleet_interval, mode=self.mode,
            serve_log=self.serve_log, broker_spec=self.broker_spec,
            stream=stream, trim=not self.admission_enabled,
            **self.controller_kwargs)
        adm = None
        if self.admission_enabled:
            kw = dict(self.admission_kwargs)
            kw.setdefault("slo_engine", self.slo_engine)
            adm = AdmissionController(self.db, stream=stream,
                                      model=name, **kw)
        return _Tenant(spec, verdict, ctrl, adm)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "ModelRouter":
        """Pick configs, prime fleets, open front doors, start the
        telemetry tick (idempotent)."""
        with self._lock:
            started = bool(self._tenants)
        if not started:
            for spec in self.specs:
                t = self._build_tenant(spec)
                with self._lock:
                    self._tenants[spec.name] = t
                if t.admission is not None:
                    t.admission.start()
                t.controller.start()
                primed = t.verdict is not None and \
                    t.verdict["replicas"] > self.min_replicas
                self._record_decision(
                    spec.name, "prime" if primed else "start",
                    detail={
                        "replicas": t.controller.replica_count(),
                        "pad_buckets": (t.verdict or {}).get(
                            "pad_buckets"),
                        "batch_budget_ms": (t.verdict or {}).get(
                            "batch_budget_ms"),
                        "quantize": (t.verdict or {}).get("quantize"),
                        "admission": t.admission is not None,
                    })
        self.metrics.models.set(len(self.specs))
        self._stop_evt.clear()
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="zoo-router")
            th = self._thread
        th.start()
        return self

    def stop(self) -> None:
        """Stop the tick, every admission controller (clearing its
        published verdict), then every fleet (clean shutdown: in-flight
        claims requeued)."""
        self._stop_evt.set()
        with self._lock:
            th = self._thread
        if th is not None:
            th.join(timeout=10.0)
        with self._lock:
            tenants = list(self._tenants.values())
        for t in tenants:
            if t.admission is not None:
                t.admission.stop()
            t.controller.stop()
            self._record_decision(t.spec.name, "stop",
                                  detail={"replicas": 0})
        self.metrics.models.set(0)

    def _run(self):
        while not self._stop_evt.wait(self.interval):
            try:
                self.tick()
            except Exception as e:
                # the router must never take the fleets down; a policy
                # bug shows in the flight ring, not an outage
                self._flight.record_exception(e, where="router")

    # ------------------------------------------------------------------
    # one telemetry window
    # ------------------------------------------------------------------
    def tick(self) -> None:
        """Refresh the per-model ``zoo_fleet_model_*`` gauges and log
        replica-count movements (the per-model scale story in ONE
        place, on top of each controller's own decision log)."""
        with self._lock:
            tenants = list(self._tenants.values())
        for t in tenants:
            name = t.spec.name
            replicas = t.controller.replica_count()
            backlog = int(self.db.unclaimed(t.stream))
            cur = t.controller.current()
            win = cur["window"]
            sig = FleetSignals(
                predict_p99_s=win["predict_p99_ms"] / 1e3,
                service_rate=win["service_rate"],
                queue_depth=win["queue_depth"],
                memory_ratio=win["memory_ratio"])
            est = t.controller.scaler.estimate_p99_s(sig)
            self.metrics.replicas.labels(model=name).set(replicas)
            self.metrics.backlog.labels(model=name).set(backlog)
            if est != float("inf"):
                self.metrics.est_p99.labels(model=name).set(est)
            with self._lock:
                prev = self._prev_replicas.get(name)
                self._prev_replicas[name] = replicas
            if prev is not None and prev != replicas:
                self._record_decision(
                    name, "scale",
                    detail={"old": prev, "new": replicas,
                            "backlog": backlog,
                            "est_p99_ms": (None if est == float("inf")
                                           else round(est * 1e3, 3))})

    def _record_decision(self, model: str, action: str, detail=None):
        row = {"ts": time.time(), "model": model, "action": action}
        if detail:
            row.update(detail)
        with self._lock:
            self._decisions.append(row)
        self.metrics.decisions.labels(model=model, action=action).inc()
        self._flight.record("router", model=model, action=action,
                            **(detail or {}))

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------
    def tenant(self, model: str) -> _Tenant:
        with self._lock:
            try:
                return self._tenants[model]
            except KeyError:
                raise KeyError(
                    f"model {model!r} is not routed; routed models: "
                    f"{sorted(self._tenants)}") from None

    def controller(self, model: str) -> FleetController:
        return self.tenant(model).controller

    def admission(self, model: str):
        return self.tenant(model).admission

    def verdict(self, model: str):
        return self.tenant(model).verdict

    def models(self) -> list:
        return [s.name for s in self.specs]

    # ------------------------------------------------------------------
    # introspection (/varz, metrics_dump, benches)
    # ------------------------------------------------------------------
    def decision_log(self) -> list:
        with self._lock:
            return list(self._decisions)

    def current(self) -> dict:
        with self._lock:
            tenants = list(self._tenants.values())
        models = {}
        for t in tenants:
            models[t.spec.name] = {
                "spec": t.spec.to_doc(),
                "stream": t.stream,
                "replicas": t.controller.replica_count(),
                "backlog": int(self.db.unclaimed(t.stream)),
                "verdict": t.verdict,
                "admission": (t.admission.current()
                              if t.admission is not None else None),
            }
        return {"models": models, "admission": self.admission_enabled,
                "mode": self.mode}

    def to_doc(self) -> dict:
        return {"current": self.current(),
                "decisions": self.decision_log()}
