"""Declarative SLOs + multi-window burn-rate alerting over a
:class:`~analytics_zoo_tpu_torch.metrics.timeseries.TimeSeriesStore`
(counterpart of ``analytics_zoo_tpu/metrics/slo.py``).

An :class:`SloSpec` names a metric family, a per-observation threshold
and an objective ("99% of predict calls complete within 500 ms").  The
:class:`SloEngine` evaluates every spec each tick using the SRE
multi-window burn-rate rule: the alert fires only when BOTH a short
window (is it happening NOW?) and a long window (has it been happening
long enough to matter?) burn the error budget above the spec's
``burn_threshold``.  A burn rate of 1.0 means errors arrive exactly as
fast as the budget allows; 14.4 means a 30-day budget dies in 2 days.
The short window makes the alert fast to RESOLVE once the cause is
fixed; the long window keeps one bad scrape from paging.

Verdicts land the three standard ways every zoo control plane uses
(autotune / fleet / elastic convention): the ``zoo_slo_*`` metric
family, ``slo_alert`` flight events, and a bounded decision log
surfaced at /varz under ``slo`` — plus the dedicated ``/alertz``
endpoint (metrics/http.py) that serves every live engine's alert state
for dashboards and the bench harness.

Spec kinds:

- ``latency`` — family is a histogram; an observation is bad when it
  lands above ``threshold`` (bucket-interpolated over the window).
- ``ceiling`` — family is a gauge; a sampled point is bad when its
  value exceeds ``threshold`` (heartbeat age, memory ratio, stall
  seconds).

Consumers: the federated ``SloScaler`` path reads the same store; in
the reference the elastic ``TrainSupervisor`` also runs a private engine
over per-worker heartbeat-age series (the port's elastic runtime waits
for ROADMAP queue 1 item 21).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref

from analytics_zoo_tpu_torch.metrics.flight import get_flight_recorder
from analytics_zoo_tpu_torch.metrics.runtime import SloMetrics
from analytics_zoo_tpu_torch.metrics.timeseries import TimeSeriesStore

__all__ = ["SloSpec", "SloEngine", "default_slos", "varz_doc",
           "alertz_doc"]

# Live engines for the /varz `slo` panel and /alertz — weak so a
# dropped engine disappears from the rollup instead of leaking.
_active: "weakref.WeakSet[SloEngine]" = weakref.WeakSet()
_active_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One service-level objective over a stored metric family.

    ``objective`` is the good-fraction target (0.99 = 1% error
    budget); ``threshold`` is the per-observation ceiling in the
    family's native unit (seconds for latency histograms)."""

    name: str
    family: str
    threshold: float
    objective: float = 0.99
    kind: str = "latency"  # "latency" (histogram) | "ceiling" (gauge)
    short_window: float = 30.0
    long_window: float = 300.0
    burn_threshold: float = 1.0
    labels: tuple = ()  # ((key, value), ...) — exact series match
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SloSpec {self.name!r}: objective must be in (0, 1), "
                f"got {self.objective}")
        if self.threshold <= 0:
            raise ValueError(
                f"SloSpec {self.name!r}: threshold must be > 0, "
                f"got {self.threshold}")
        if not 0 < self.short_window < self.long_window:
            raise ValueError(
                f"SloSpec {self.name!r}: need 0 < short_window "
                f"({self.short_window}) < long_window "
                f"({self.long_window})")
        if self.kind not in ("latency", "ceiling"):
            raise ValueError(
                f"SloSpec {self.name!r}: kind must be 'latency' or "
                f"'ceiling', got {self.kind!r}")
        if self.burn_threshold <= 0:
            raise ValueError(
                f"SloSpec {self.name!r}: burn_threshold must be > 0, "
                f"got {self.burn_threshold}")

    def label_dict(self) -> dict | None:
        return dict(self.labels) if self.labels else None

    def to_doc(self) -> dict:
        return {
            "name": self.name, "family": self.family,
            "threshold": self.threshold, "objective": self.objective,
            "kind": self.kind, "short_window": self.short_window,
            "long_window": self.long_window,
            "burn_threshold": self.burn_threshold,
            "labels": dict(self.labels),
            "description": self.description,
        }


def default_slos(slo_p99_ms: float = 500.0,
                 step_budget_s: float = 1.0,
                 ckpt_stall_s: float = 1.0,
                 heartbeat_stale_s: float = 10.0,
                 short_window: float = 30.0,
                 long_window: float = 300.0,
                 burn_threshold: float = 1.0) -> list[SloSpec]:
    """The four stock SLOs the zoowatch plane watches out of the box.

    The heartbeat SLO rides on the scraper's own staleness gauge, so a
    host that stops answering /varz burns budget even though none of
    ITS metrics move — the federation-tier liveness check."""
    common = dict(short_window=short_window, long_window=long_window,
                  burn_threshold=burn_threshold)
    return [
        SloSpec("predict_latency", "zoo_serving_predict_seconds",
                threshold=slo_p99_ms / 1e3, objective=0.99,
                description="serving predict p99 budget", **common),
        SloSpec("step_time", "zoo_train_step_seconds",
                threshold=step_budget_s, objective=0.95,
                description="training step-time budget", **common),
        SloSpec("checkpoint_stall", "zoo_ckpt_stall_seconds",
                threshold=ckpt_stall_s, objective=0.99,
                description="async checkpoint stall budget", **common),
        SloSpec("worker_heartbeat", "zoo_scrape_staleness_seconds",
                threshold=heartbeat_stale_s, objective=0.90,
                kind="ceiling",
                description="scrape-target freshness (host liveness)",
                **common),
    ]


class SloEngine:
    """Evaluates SLO specs against a store; holds alert state.

    ``evaluate()`` is the tick — call it from whatever loop already
    owns the store's cadence (the scraper's poll loop passes itself as
    ``on_scrape`` hook, the supervisor ticks its private engine).  The
    engine never starts threads of its own."""

    def __init__(self, store: TimeSeriesStore,
                 specs: list | tuple = (),
                 registry=None, flight=None,
                 log_capacity: int = 256, clock=time.time):
        self.store = store
        self.metrics = SloMetrics(registry)
        self._flight = flight if flight is not None \
            else get_flight_recorder()
        self._clock = clock
        self._lock = threading.Lock()
        self._specs: dict[str, SloSpec] = {}  # guarded-by: _lock
        self._alerts: dict[str, dict] = {}  # guarded-by: _lock
        # bounded decision log (firing/resolved transitions), /varz slo
        self._decisions = collections.deque(  # guarded-by: _lock
            maxlen=int(log_capacity))
        for spec in specs:
            self.add_spec(spec)
        with _active_lock:
            _active.add(self)

    def add_spec(self, spec: SloSpec):
        if not isinstance(spec, SloSpec):
            raise TypeError(f"expected SloSpec, got {type(spec)!r}")
        with self._lock:
            self._specs[spec.name] = spec

    def specs(self) -> list[SloSpec]:
        with self._lock:
            return list(self._specs.values())

    # -- evaluation -----------------------------------------------------
    def _burns(self, spec: SloSpec, now: float) -> tuple[float, float]:
        labels = spec.label_dict()
        short = self.store.burn_rate(
            spec.family, spec.threshold, spec.objective,
            spec.short_window, labels=labels, now=now)
        long_ = self.store.burn_rate(
            spec.family, spec.threshold, spec.objective,
            spec.long_window, labels=labels, now=now)
        return short, long_

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One tick over every spec; returns the CURRENTLY FIRING
        alerts.  Transitions (quiet->firing, firing->resolved) land in
        the flight recorder and the decision log; burn gauges update
        every tick."""
        t = now if now is not None else self._clock()
        with self._lock:
            specs = list(self._specs.values())
        firing_now = []
        for spec in specs:
            # store queries take the STORE's lock; never ours
            short, long_ = self._burns(spec, t)
            firing = (short >= spec.burn_threshold
                      and long_ >= spec.burn_threshold)
            if self.metrics.enabled:
                self.metrics.burn_rate.labels(
                    slo=spec.name, window="short").set(short)
                self.metrics.burn_rate.labels(
                    slo=spec.name, window="long").set(long_)
                self.metrics.alert_active.labels(
                    slo=spec.name).set(1.0 if firing else 0.0)
            with self._lock:
                prev = self._alerts.get(spec.name)
                was_firing = bool(prev and prev.get("firing"))
                alert = {
                    "slo": spec.name, "firing": firing,
                    "short_burn": round(short, 4),
                    "long_burn": round(long_, 4),
                    "burn_threshold": spec.burn_threshold,
                    "threshold": spec.threshold,
                    "objective": spec.objective,
                    "since": (prev.get("since") if was_firing and firing
                              else (t if firing else None)),
                    "ts": t,
                }
                self._alerts[spec.name] = alert
                transition = None
                if firing and not was_firing:
                    transition = "firing"
                elif was_firing and not firing:
                    transition = "resolved"
                if transition:
                    self._decisions.append({
                        "ts": t, "slo": spec.name, "state": transition,
                        "short_burn": round(short, 4),
                        "long_burn": round(long_, 4),
                    })
            if transition:
                if self.metrics.enabled and transition == "firing":
                    self.metrics.alerts.labels(slo=spec.name).inc()
                self._flight.record(
                    "slo_alert", slo=spec.name, state=transition,
                    short_burn=round(short, 4),
                    long_burn=round(long_, 4),
                    threshold=spec.threshold)
            if firing:
                firing_now.append(alert)
        if self.metrics.enabled:
            self.metrics.evaluations.inc()
        return firing_now

    # -- introspection --------------------------------------------------
    def alerts(self) -> list[dict]:
        """Latest verdict per spec (firing and quiet both listed)."""
        with self._lock:
            return [dict(a) for a in self._alerts.values()]

    def firing(self) -> list[dict]:
        return [a for a in self.alerts() if a.get("firing")]

    def decision_log(self) -> list[dict]:
        with self._lock:
            return list(self._decisions)

    def to_doc(self) -> dict:
        with self._lock:
            specs = [s.to_doc() for s in self._specs.values()]
            alerts = [dict(a) for a in self._alerts.values()]
            decisions = list(self._decisions)
        return {"specs": specs, "alerts": alerts,
                "decisions": decisions}


def varz_doc() -> list[dict]:
    """Docs for every live engine — the /varz ``slo`` panel (same
    sys.modules-gated pattern as autotune/fleet/elastic)."""
    with _active_lock:
        engines = list(_active)
    return [e.to_doc() for e in engines]


def alertz_doc() -> dict:
    """The /alertz body: one merged alert view across live engines."""
    with _active_lock:
        engines = list(_active)
    alerts = []
    for e in engines:
        alerts.extend(e.alerts())
    return {
        "ts": time.time(),
        "engines": len(engines),
        "firing": [a for a in alerts if a.get("firing")],
        "alerts": alerts,
    }
