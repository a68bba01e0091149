"""Typed front-door admission control for the serving plane (counterpart
of ``analytics_zoo_tpu/serving/admission.py``).

The fleet's old overload valve was the SERVER trimming the stream when
the broker neared memory capacity — which drops records that were
already accepted, silently breaking the client's contract.  This
module moves the shedding to the FRONT DOOR: an
:class:`AdmissionController` watches broker pressure, per-stream
backlog, and the SLO burn headroom (the
:class:`~analytics_zoo_tpu_torch.metrics.slo.SloEngine` multi-window signal
that fires BEFORE the hard violation — BENCH_FED_r15), and publishes a
per-stream verdict hash (``admission:<stream>``) on the broker.
Clients read the verdict at enqueue and raise the typed
:class:`~analytics_zoo_tpu_torch.serving.client.ServingRejected` (with the
retry-after hint sized from the observed drain rate) BEFORE the record
enters the stream.  Admission-guarded servers run with ``trim=False``:
once a record is accepted it is served exactly once, full stop.

Verdicts land the standard three ways: the ``zoo_admission_*`` metric
family, an ``admission`` flight event on every state transition, and a
bounded decision log served in the ``admission`` section of ``/varz``
(rendered by ``tools/metrics_dump.py``).  Gate: ``ZOO_ADMISSION``
(ZooConfig) — the router only attaches a controller when it is on.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque

from ..metrics import AdmissionMetrics, get_flight_recorder
from .broker import connect_broker
from .client import ADMISSION_KEY_PREFIX, INPUT_STREAM

__all__ = ["AdmissionController", "varz_doc",
           "DEFAULT_MEMORY_HIGH", "DEFAULT_RESUME_RATIO"]

#: broker memory ratio at which admission sheds — deliberately BELOW
#: the server's trim threshold (``ClusterServing.INPUT_THRESHOLD`` =
#: 0.48): the front door closes before the back-pressure valve would
#: ever need to drop accepted work.
DEFAULT_MEMORY_HIGH = 0.4

#: hysteresis: a shedding stream re-opens only once its backlog has
#: drained below this fraction of the shed threshold — without it the
#: verdict flaps at the boundary and clients see accept/reject noise.
DEFAULT_RESUME_RATIO = 0.5


# ---------------------------------------------------------------------------
# Live-controller registry for /varz (metrics/http.py consults
# sys.modules only — a scrape-only process never imports this module).
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: "weakref.WeakSet[AdmissionController]" = (  # guarded-by: _active_lock
    weakref.WeakSet())


def varz_doc() -> dict:
    """The ``admission`` section of ``/varz``: every live controller's
    current verdict plus the merged, time-ordered decision log."""
    with _active_lock:
        ctrls = list(_active)
    docs = [c.to_doc() for c in ctrls]
    decisions = sorted((d for doc in docs for d in doc["decisions"]),
                      key=lambda d: d["ts"])
    return {"controllers": docs, "decisions": decisions}


class AdmissionController:
    """Publish accept/shed verdicts for ONE stream.

    ``backlog_limit`` is the total outstanding-record depth (stream
    xlen: unclaimed plus claimed-but-unserved) beyond which new work is
    shed (size it from the fleet's capacity: replicas × service_rate ×
    the SLO's queueing headroom); ``slo_engine`` adds
    the burn-rate trigger — any FIRING alert among ``slo_names``
    (default: all of the engine's alerts) sheds, so the door closes on
    the early-warning signal instead of the violation.  ``admit()`` is
    the in-process front door (counts + raises); cross-process clients
    read the published verdict hash instead."""

    def __init__(self, broker, stream: str = INPUT_STREAM,
                 model: str = "default",
                 backlog_limit: int | None = None,
                 memory_high: float = DEFAULT_MEMORY_HIGH,
                 resume_ratio: float = DEFAULT_RESUME_RATIO,
                 slo_engine=None, slo_names=None,
                 interval: float = 0.25,
                 min_retry_ms: float = 50.0,
                 max_retry_ms: float = 5000.0,
                 registry=None, log_capacity: int = 256):
        if backlog_limit is not None and backlog_limit < 1:
            raise ValueError(
                f"backlog_limit must be >= 1, got {backlog_limit}")
        if not 0.0 < memory_high <= 1.0:
            raise ValueError(
                f"memory_high must be in (0, 1], got {memory_high}")
        if not 0.0 < resume_ratio <= 1.0:
            raise ValueError(
                f"resume_ratio must be in (0, 1], got {resume_ratio}")
        self.db = connect_broker(broker)
        self.stream = str(stream)
        self.model = str(model)
        self.backlog_limit = backlog_limit
        self.memory_high = float(memory_high)
        self.resume_ratio = float(resume_ratio)
        self.slo_engine = slo_engine
        self.slo_names = set(slo_names) if slo_names else None
        self.interval = float(interval)
        self.min_retry_ms = float(min_retry_ms)
        self.max_retry_ms = float(max_retry_ms)
        self.metrics = AdmissionMetrics(registry=registry)
        self._flight = get_flight_recorder()
        self._lock = threading.Lock()
        self._state = "accept"  # guarded-by: _lock
        self._reason = ""  # guarded-by: _lock
        self._retry_after_ms = 0.0  # guarded-by: _lock
        self._decisions: deque = (  # guarded-by: _lock
            deque(maxlen=int(log_capacity)))
        self._prev_backlog: int | None = None  # guarded-by: _lock
        self._prev_t: float | None = None  # guarded-by: _lock
        self._drain_rate = 0.0  # guarded-by: _lock
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._stop_evt = threading.Event()
        self.metrics.state.labels(model=self.model).set(0)
        with _active_lock:
            _active.add(self)

    # ------------------------------------------------------------------
    # the verdict
    # ------------------------------------------------------------------
    def _verdict_key(self) -> str:
        return ADMISSION_KEY_PREFIX + self.stream

    def evaluate(self) -> dict:
        """One admission tick: read the signals, decide, publish.

        Shed triggers (first match wins the reason): broker memory
        pressure (``broker_pressure``), a firing SLO burn alert
        (``slo_burn``), backlog beyond the limit (``backlog``).  A
        shedding stream re-opens only when EVERY trigger has cleared
        AND the backlog sits below ``resume_ratio × backlog_limit``
        (hysteresis).  Returns the published verdict dict."""
        now = time.monotonic()
        memory_ratio = float(self.db.memory_ratio())
        # TOTAL outstanding accepted work: records stay in the stream
        # until release(done=True), so xlen = unclaimed + claimed-but-
        # unserved.  Gating on unclaimed() alone undercounts — replicas
        # claim a full batch ahead of serving it, and that claimed
        # queue is sojourn time the client still pays.
        backlog = int(self.db.xlen(self.stream))
        with self._lock:
            prev_b, prev_t = self._prev_backlog, self._prev_t
            self._prev_backlog, self._prev_t = backlog, now
            if prev_b is not None and prev_t is not None and now > prev_t:
                drained = (prev_b - backlog) / (now - prev_t)
                if drained > 0:
                    self._drain_rate = drained
            drain_rate = self._drain_rate
            state = self._state
        burn = self._slo_firing()
        reason = ""
        if memory_ratio >= self.memory_high:
            reason = "broker_pressure"
        elif burn:
            reason = f"slo_burn:{burn}"
        elif self.backlog_limit is not None \
                and backlog >= self.backlog_limit:
            reason = "backlog"
        if state == "shed" and not reason:
            # hysteresis: hold the door shut until the backlog is
            # genuinely drained, not merely one record under the limit
            floor = (self.backlog_limit * self.resume_ratio
                     if self.backlog_limit is not None else 0)
            if backlog > floor:
                reason = "draining"
        new_state = "shed" if reason else "accept"
        retry_ms = 0.0
        if new_state == "shed":
            # size the hint from how long the EXCESS backlog takes to
            # drain at the observed rate; bounded so a stalled fleet
            # does not publish infinite waits
            floor = (self.backlog_limit * self.resume_ratio
                     if self.backlog_limit is not None else 0)
            excess = max(backlog - floor, 1)
            if drain_rate > 0:
                retry_ms = excess / drain_rate * 1e3
            else:
                retry_ms = self.max_retry_ms
            retry_ms = min(max(retry_ms, self.min_retry_ms),
                           self.max_retry_ms)
        verdict = {"state": new_state,
                   "retry_after_ms": f"{retry_ms:.1f}",
                   "reason": reason, "ts": f"{time.time():.3f}"}
        self.db.hset(self._verdict_key(), verdict)
        self.metrics.evaluations.inc()
        self.metrics.state.labels(model=self.model).set(
            1 if new_state == "shed" else 0)
        self.metrics.retry_after.labels(model=self.model).set(
            retry_ms / 1e3)
        with self._lock:
            transition = new_state != self._state
            self._state = new_state
            self._reason = reason
            self._retry_after_ms = retry_ms
            if transition:
                self._decisions.append({
                    "ts": time.time(), "model": self.model,
                    "state": new_state, "reason": reason,
                    "retry_after_ms": round(retry_ms, 1),
                    "backlog": backlog,
                    "memory_ratio": round(memory_ratio, 4)})
        if transition:
            self._flight.record(
                "admission", model=self.model, state=new_state,
                reason=reason, retry_after_ms=round(retry_ms, 1),
                backlog=backlog, memory_ratio=round(memory_ratio, 4))
        return verdict

    def _slo_firing(self) -> str:
        """Name of the first firing burn alert this controller watches,
        or empty string."""
        if self.slo_engine is None:
            return ""
        try:
            firing = self.slo_engine.firing()
        except Exception:
            return ""  # a broken engine must not wedge the front door
        names = sorted(str(a.get("slo", "")) for a in firing)
        for name in names:
            if name and (self.slo_names is None
                         or name in self.slo_names):
                return name
        return ""

    # ------------------------------------------------------------------
    # the in-process front door
    # ------------------------------------------------------------------
    def admit(self, uri: str = "") -> None:
        """Accept-or-raise for in-process producers (the bench's load
        generator, an embedded gateway).  Counts every verdict under
        ``zoo_admission_requests_total{model,verdict}``; sheds raise
        :class:`~analytics_zoo_tpu_torch.serving.client.ServingRejected` with
        the current retry-after hint."""
        with self._lock:
            state = self._state
            reason = self._reason
            retry_ms = self._retry_after_ms
        if state == "shed":
            self.metrics.requests.labels(
                model=self.model, verdict="shed").inc()
            from .client import ServingRejected

            raise ServingRejected(uri, retry_after_s=retry_ms / 1e3,
                                  reason=reason)
        self.metrics.requests.labels(
            model=self.model, verdict="accept").inc()

    def state(self) -> str:
        with self._lock:
            return self._state

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "AdmissionController":
        """Tick :meth:`evaluate` on a daemon thread (idempotent)."""
        self._stop_evt.clear()
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="zoo-admission")
            t = self._thread
        t.start()
        return self

    def stop(self) -> None:
        """Stop the loop and clear the published verdict (an absent
        hash means unguarded — clients stop paying the verdict read)."""
        self._stop_evt.set()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        try:
            self.db.delete(self._verdict_key())
        except Exception:
            pass  # broker already gone: nothing to clear

    def _run(self):
        while not self._stop_evt.wait(self.interval):
            try:
                self.evaluate()
            except Exception as e:
                # the front door must never crash the serving plane; a
                # policy bug shows in the flight ring, not an outage
                self._flight.record_exception(e, where="admission")

    # ------------------------------------------------------------------
    # introspection (/varz, metrics_dump, benches)
    # ------------------------------------------------------------------
    def decision_log(self) -> list:
        with self._lock:
            return list(self._decisions)

    def current(self) -> dict:
        with self._lock:
            return {
                "model": self.model, "stream": self.stream,
                "state": self._state, "reason": self._reason,
                "retry_after_ms": round(self._retry_after_ms, 1),
                "backlog_limit": self.backlog_limit,
                "memory_high": self.memory_high,
                "drain_rate": round(self._drain_rate, 3),
            }

    def to_doc(self) -> dict:
        return {"current": self.current(),
                "decisions": self.decision_log()}
