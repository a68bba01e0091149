"""Metrics registry — labeled Counter / Gauge / Histogram families.

The framework-wide measurement substrate: every hot path
(estimator fit loop, serving step, inference predict) records into a
process-global :class:`MetricsRegistry`, and exporters
(:mod:`analytics_zoo_tpu_torch.metrics.exporters`) render one snapshot in
Prometheus text, JSONL, or TensorBoard scalars.  The data model is the
Prometheus one — a *family* (name, kind, help, label names) owning one
*child* per label-value combination — because that is what every
downstream consumer (scrapers, dashboards, ``tools/metrics_dump.py``)
already knows how to read.

Design constraints, in order:

1. **Zero cost when disabled.**  A disabled registry hands back one
   shared :data:`NULL` singleton from every ``counter()/gauge()/
   histogram()/labels()`` call — no dict insert, no child allocation, no
   per-step garbage on the hot path (asserted by identity in
   ``tests/test_metrics.py``).
2. **Thread-safe.**  The serving loop, the infeed thread and predict
   callers all record concurrently; family creation holds the registry
   lock, child updates hold a per-family lock (Python float ``+=`` is
   three bytecodes, not atomic).
3. **Bounded memory.**  Histograms are fixed-bucket (counts + sum), so a
   multi-day job's telemetry is O(buckets), never O(observations);
   p50/p95/p99 come from linear interpolation inside the bucket bounds.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
from typing import Sequence

__all__ = [
    "NULL", "NullMetric", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "get_registry", "set_registry",
    "DEFAULT_BUCKETS",
]

# Latency-shaped default buckets (seconds), Prometheus-style: the serving
# path spans ~100us jit dispatch to multi-second cold compiles.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class _NullTimer:
    """Reusable no-op context manager (``nullcontext`` allocates per use
    on some versions; this one is a shared singleton)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class NullMetric:
    """The disabled-mode no-op: one shared instance answers every metric
    call on a disabled registry.  ``labels()`` returns itself, so chains
    like ``reg.counter(...).labels(x="1").inc()`` allocate nothing."""

    __slots__ = ()

    def labels(self, **kwargs):
        return self

    def inc(self, amount: float = 1.0):
        pass

    def dec(self, amount: float = 1.0):
        pass

    def set(self, value: float):
        pass

    def observe(self, value: float):
        pass

    def time(self):
        return _NULL_TIMER

    def get(self) -> float:
        return 0.0

    def summary(self) -> dict:
        return {}

    def percentile(self, q: float) -> float:
        return 0.0

    def snapshot_state(self):
        return None

    def delta_since(self, prev) -> dict:
        return {}


NULL = NullMetric()


class _Timer:
    """``with child.time():`` — observe the block's wall seconds."""

    __slots__ = ("_child", "_t0")

    def __init__(self, child):
        self._child = child

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self._child.observe(time.perf_counter() - self._t0)
        return False


class _Family:
    """Base: a named metric family owning labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}  # guarded-by: _lock

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **kwargs):
        """Child for one label-value combination (created on demand)."""
        if set(kwargs) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kwargs)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kwargs[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    self._children[key] = child
        return child

    def _default(self):
        """The unlabeled child — families with no labelnames proxy their
        value methods straight to it."""
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                "call .labels(...) first")
        return self.labels()

    def samples(self) -> list[tuple[dict, object]]:
        """[(labels_dict, child)] snapshot for exporters."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0  # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    def get(self) -> float:
        return self._value


class Counter(_Family):
    """Monotonically increasing count (records served, steps run)."""

    kind = "counter"
    _new_child = _CounterChild

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def get(self) -> float:
        return self._default().get()


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0  # guarded-by: _lock
        self._lock = threading.Lock()

    def set(self, value: float):
        # single STORE of an immutable float: atomic under the GIL, and
        # last-writer-wins is exactly gauge semantics — taking the lock
        # here would serialize every hot-path set() against inc()
        # zoolint: disable=guarded-by -- atomic replace; gauge is last-writer-wins
        self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def get(self) -> float:
        return self._value


class Gauge(_Family):
    """Point-in-time value (queue depth, memory ratio, throughput)."""

    kind = "gauge"
    _new_child = _GaugeChild

    def set(self, value: float):
        self._default().set(value)

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default().dec(amount)

    def get(self) -> float:
        return self._default().get()


class _HistogramChild:
    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_inf_sum",
                 "_lock")

    def __init__(self, bounds: tuple):
        self._bounds = bounds  # ascending finite upper bounds; immutable
        self._counts = [0] * (len(bounds) + 1)  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock
        self._inf_sum = 0.0  # guarded-by: _lock (sum past the last bound)
        self._lock = threading.Lock()

    def observe(self, value: float):
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if i == len(self._bounds):
                self._inf_sum += value

    def time(self):
        return _Timer(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _snapshot(self) -> tuple[list[int], float, int, float]:
        """One locked copy of (counts, sum, count, inf_sum) — every
        multi-value read (summary, percentile) derives from a SINGLE
        snapshot so one exported row can never mix states (e.g. show
        p99 < p50 because a burst landed between two reads)."""
        with self._lock:
            return (list(self._counts), self._sum, self._count,
                    self._inf_sum)

    def export_state(self) -> tuple[list[tuple[float, int]], float, int]:
        """(cumulative buckets, sum, count) from ONE snapshot, so the
        Prometheus invariant ``_bucket{le="+Inf"} == _count`` holds even
        while another thread observes mid-export."""
        counts, total_sum, count, _ = self._snapshot()
        out, cum = [], 0
        for b, c in zip(self._bounds, counts):
            cum += c
            out.append((b, cum))
        out.append((math.inf, cum + counts[-1]))
        return out, total_sum, count

    def buckets(self) -> list[tuple[float, int]]:
        """[(upper_bound, CUMULATIVE count)], Prometheus `le` semantics,
        ending with (+Inf, total)."""
        return self.export_state()[0]

    def _percentile_from(self, snap, q: float) -> float:
        """Quantile estimate by linear interpolation within the bucket
        containing rank q*count (the standard fixed-bucket estimator —
        exact to within one bucket width)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} not in [0, 1]")
        counts, _, total, inf_sum = snap
        if total == 0:
            return 0.0
        rank = q * total
        prev_bound, prev_cum = 0.0, 0
        cum = 0
        for bound, c in zip(self._bounds + (math.inf,), counts):
            cum += c
            if cum >= rank:
                if math.isinf(bound):
                    # open-ended tail: the point estimate is the mean of
                    # the observations that actually landed PAST the
                    # last bound (tracked separately in _inf_sum, so a
                    # 120s stall is reported as ~120s, not clamped to
                    # the last bucket bound)
                    n_inf = cum - prev_cum
                    if n_inf == 0:
                        return prev_bound
                    return max(inf_sum / n_inf, prev_bound)
                if cum == prev_cum:
                    return bound
                frac = (rank - prev_cum) / (cum - prev_cum)
                return prev_bound + frac * (bound - prev_bound)
            prev_bound, prev_cum = bound, cum
        return prev_bound

    def percentile(self, q: float) -> float:
        return self._percentile_from(self._snapshot(), q)

    def summary(self) -> dict:
        """{count, sum, mean, p50, p95, p99} — the exporter/report
        shape, all derived from ONE consistent snapshot."""
        return self._summary_of(self._snapshot())

    def _summary_of(self, snap) -> dict:
        _, total_sum, c, _ = snap
        return {
            "count": c,
            "sum": total_sum,
            "mean": (total_sum / c) if c else 0.0,
            "p50": self._percentile_from(snap, 0.50),
            "p95": self._percentile_from(snap, 0.95),
            "p99": self._percentile_from(snap, 0.99),
        }

    def snapshot_state(self) -> tuple:
        """Opaque cumulative state for :meth:`delta_since` — take one
        before a window, hand it back after to summarize only what
        landed in between."""
        return self._snapshot()

    def delta_since(self, prev: tuple | None) -> dict:
        """Summary of the observations since ``prev`` (a value from
        :meth:`snapshot_state`; ``None`` means since child creation).

        Histograms are cumulative, which is the right export shape but
        the WRONG controller input: a decision loop (feature/autotune.py)
        must react to *recent* behavior, not a lifetime blur where the
        first hour of a run outvotes the last minute.  Bucket counts and
        sums are monotone, so the window is an exact bucket-wise
        subtraction; p50/p95/p99/mean are then computed on the window's
        own distribution.  An empty window returns ``count == 0`` and
        zeros.  ``prev`` from a child with different bucket bounds
        raises; a ``prev`` AHEAD of the current state (the child was
        replaced/reset under the caller) degrades to the full current
        summary instead of reporting negative counts.
        """
        cur = self._snapshot()
        if prev is None:
            return self._summary_of(cur)
        p_counts, p_sum, p_count, p_inf = prev
        c_counts, c_sum, c_count, c_inf = cur
        if len(p_counts) != len(c_counts):
            raise ValueError(
                f"snapshot has {len(p_counts)} buckets but histogram has "
                f"{len(c_counts)} — delta_since needs a snapshot of THIS "
                "child")
        d_counts = [c - p for c, p in zip(c_counts, p_counts)]
        if any(d < 0 for d in d_counts) or c_count < p_count:
            return self._summary_of(cur)  # reset under us: full window
        return self._summary_of(
            (d_counts, c_sum - p_sum, c_count - p_count, c_inf - p_inf))


class Histogram(_Family):
    """Fixed-bucket distribution (latencies, batch sizes)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(math.isinf(b) for b in bounds):
            raise ValueError("+Inf bucket is implicit; pass finite bounds")
        self.bucket_bounds = bounds

    def _new_child(self):
        return _HistogramChild(self.bucket_bounds)

    def observe(self, value: float):
        self._default().observe(value)

    def time(self):
        return self._default().time()

    def percentile(self, q: float) -> float:
        return self._default().percentile(q)

    def summary(self) -> dict:
        return self._default().summary()

    def snapshot_state(self) -> tuple:
        return self._default().snapshot_state()

    def delta_since(self, prev: tuple | None) -> dict:
        return self._default().delta_since(prev)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe family registry.

    ``enabled=False`` turns every factory method into a return of the
    shared :data:`NULL` no-op (the zero-cost-when-disabled contract);
    flipping :meth:`set_enabled` later affects only *subsequent* factory
    calls — code that cached a real child keeps recording into it.
    """

    def __init__(self, enabled: bool = True):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}  # guarded-by: _lock
        self.enabled = bool(enabled)

    def set_enabled(self, enabled: bool):
        self.enabled = bool(enabled)

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        if not self.enabled:
            return NULL
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = cls(name, help, labelnames, **kwargs)
                    self._families[name] = fam
        if not isinstance(fam, cls) or \
                fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} re-registered as {cls.kind} with labels "
                f"{tuple(labelnames)} but exists as {fam.kind} with "
                f"labels {fam.labelnames}")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] | None = None) -> Histogram:
        """``buckets=None`` means DEFAULT_BUCKETS at creation and
        no-check on access (callers reading an existing family need not
        know its bounds); EXPLICIT buckets that conflict with the
        existing family raise — silently landing observations in the
        wrong bounds would corrupt every percentile."""
        fam = self._get_or_create(
            Histogram, name, help, labelnames,
            buckets=DEFAULT_BUCKETS if buckets is None else buckets)
        if buckets is not None and isinstance(fam, Histogram):
            expected = tuple(sorted(float(b) for b in buckets))
            if fam.bucket_bounds != expected:
                raise ValueError(
                    f"histogram {name!r} re-registered with buckets "
                    f"{expected} but exists with {fam.bucket_bounds}")
        return fam

    def collect(self) -> list[_Family]:
        """Families sorted by name (exporter input)."""
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def clear(self):
        with self._lock:
            self._families.clear()


# ---------------------------------------------------------------------------
# Process-global default registry.  ZOO_METRICS=0 disables it at creation —
# the env tier matching ZooConfig's other knobs (common/engine.py).
# ---------------------------------------------------------------------------

_default: MetricsRegistry | None = None  # guarded-by: _default_lock
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry every built-in instrumentation site
    records into (estimator fit loop, serving step, inference predict)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MetricsRegistry(
                    enabled=os.environ.get("ZOO_METRICS", "1") != "0")
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests, embedding apps); returns
    the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev
