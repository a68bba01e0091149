"""Health model — component heartbeats with stale-threshold rollup.

The ``/healthz`` contract a load balancer or kubelet needs: a
process is *healthy* iff every registered component has heartbeat
recently.  Components are the long-lived loops whose silence means the
process is wedged even though it still accepts TCP connections — the
serving loop, the infeed feeder, actor connections.  Each registers with
a ``stale_after`` budget; :meth:`HealthRegistry.status` rolls the ages
up into one verdict, and :class:`~analytics_zoo_tpu_torch.metrics.http.
MetricsServer` maps that verdict onto 200/503.

Transitions (healthy -> stale and back) are recorded into the flight
recorder (:mod:`analytics_zoo_tpu_torch.metrics.flight`) when one is
installed, so a postmortem dump shows *when* a component went quiet,
not just that it was quiet at the end.

Thread-safety: heartbeats come from the serving loop, the feeder thread
and actor pumps concurrently; a heartbeat is one locked dict write.
"""

from __future__ import annotations

import threading
import time

__all__ = ["HealthRegistry", "get_health", "set_health"]

# A component that never declared its own budget is considered wedged
# after this many seconds of silence.
DEFAULT_STALE_AFTER = 15.0


class HealthRegistry:
    """Named component heartbeats + stale rollup.

    ``register`` is idempotent (safe in constructors / loop preambles);
    ``heartbeat`` auto-registers unknown components with the default
    budget so instrumentation sites need no setup ceremony.
    """

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        # name -> [stale_after, last_beat, last_verdict_healthy, forced]
        # forced is None (age-driven) or an explicit bool verdict for
        # components that are idle-OK but break-FAIL (actor connections:
        # no traffic is fine, a broken pipe is not)
        self._components: dict[str, list] = {}  # guarded-by: _lock

    def register(self, component: str,
                 stale_after: float = DEFAULT_STALE_AFTER):
        """Declare a component (and its silence budget); beats it once."""
        with self._lock:
            entry = self._components.get(component)
            if entry is None:
                self._components[component] = [float(stale_after),
                                               self._clock(), True, None]
            else:
                entry[0] = float(stale_after)
                entry[1] = self._clock()

    def heartbeat(self, component: str):
        with self._lock:
            entry = self._components.get(component)
            if entry is None:
                self._components[component] = [DEFAULT_STALE_AFTER,
                                               self._clock(), True, None]
            else:
                entry[1] = self._clock()
                entry[3] = None  # fresh beat overrides a forced verdict

    def set_status(self, component: str, healthy: bool):
        """Explicit verdict for components with no natural cadence: the
        rollup uses it instead of the age check until the next
        heartbeat.  An actor connection is marked healthy at spawn and
        unhealthy when its pipe/socket breaks — silence in between is
        not staleness."""
        with self._lock:
            entry = self._components.get(component)
            if entry is None:
                entry = [DEFAULT_STALE_AFTER, self._clock(), True, None]
                self._components[component] = entry
            entry[1] = self._clock()
            entry[3] = bool(healthy)

    def unregister(self, component: str):
        """Drop a component (a loop that finished *on purpose* must not
        read as wedged forever after)."""
        with self._lock:
            self._components.pop(component, None)

    def status(self) -> dict:
        """Rollup: ``{"healthy": bool, "components": {name: {...}}}``.

        Healthy iff every registered component's age is within its
        budget (an empty registry is healthy: nothing claimed to be
        alive, so nothing is provably wedged).  Observing a component
        cross its threshold (either direction) records one ``health``
        transition event into the flight recorder.
        """
        now = self._clock()
        transitions = []
        components = {}
        healthy = True
        with self._lock:
            for name, entry in self._components.items():
                stale_after, last_beat, was_healthy, forced = entry
                age = now - last_beat
                ok = forced if forced is not None else age <= stale_after
                if ok != was_healthy:
                    entry[2] = ok
                    transitions.append((name, ok, age))
                healthy = healthy and ok
                components[name] = {
                    "healthy": ok,
                    "age_seconds": round(age, 3),
                    "stale_after_seconds": stale_after,
                }
                if forced is not None:
                    components[name]["forced"] = forced
        for name, ok, age in transitions:
            _record_transition(name, ok, age)
        return {"healthy": healthy, "components": components}


def _record_transition(component: str, healthy: bool, age: float):
    """Flight-recorder hook (lazy import: flight.py never imports us)."""
    try:
        from analytics_zoo_tpu_torch.metrics.flight import get_flight_recorder

        get_flight_recorder().record(
            "health", component=component,
            state="healthy" if healthy else "stale",
            age_seconds=round(age, 3))
    except Exception:  # health must never take the caller down
        pass


# ---------------------------------------------------------------------------
# Process-global default, matching get_registry()/get_tracer().
# ---------------------------------------------------------------------------

_default: HealthRegistry | None = None  # guarded-by: _default_lock
_default_lock = threading.Lock()


def get_health() -> HealthRegistry:
    """The process-global health registry every built-in loop beats."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = HealthRegistry()
    return _default


def set_health(health: HealthRegistry) -> HealthRegistry:
    """Swap the process-global health registry (tests); returns the
    previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, health
    return prev
