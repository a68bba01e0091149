"""Time-series windows over telemetry snapshots — the history /varz never had
(counterpart of ``analytics_zoo_tpu/metrics/timeseries.py``).

Every exporter in the stack serves the registry's *current* cumulative
state; every controller that needs "recent behavior" (autotune, the
fleet scaler) keeps its own private ``snapshot_state()`` baseline.  The
:class:`TimeSeriesStore` makes that pattern a shared primitive: a
bounded per-series ring of timestamped points in the MERGEABLE sample
format (:func:`analytics_zoo_tpu_torch.metrics.merge.registry_samples` — the
shape the federation scraper pulls off the wire), answering the three
window queries the zoowatch control planes need:

- :meth:`rate` — counter increase per second over a trailing window
  (monotone-reset tolerant, the Prometheus ``rate()`` contract);
- :meth:`percentile_over` / :meth:`window_summary` — a histogram's
  distribution over ONLY the window, by bucket-wise subtraction of the
  cumulative state at the window's edges.  The subtraction and
  interpolation are the registry's own: points store
  ``Histogram.delta_since``-compatible state tuples and the summary is
  computed by ``_HistogramChild.delta_since`` itself, so window
  percentiles here and in the autotuner can never drift apart;
- :meth:`burn_rate` — the SRE error-budget burn over a window: the
  fraction of observations that violated an SLO threshold, divided by
  the budget ``(1 - objective)``.  ``1.0`` = burning exactly at budget;
  the multi-window alert rule lives in :mod:`analytics_zoo_tpu_torch.metrics.
  slo`.

Per-host series: ingest labels samples with their source (the scraper
passes ``source={"host": target}``), and every query takes ``labels``
— ``None`` AGGREGATES across all series of the family (counters sum,
histograms merge bucket-wise when bounds agree), which is exactly the
fleet-wide view the federated scaler reads.

Thread-safety: one lock around the ring dict; ingestion comes from the
scraper thread while queries come from scaler/engine ticks.  Nothing
blocking is called under the lock.
"""

from __future__ import annotations

import threading
import time

from analytics_zoo_tpu_torch.metrics.registry import _HistogramChild

__all__ = ["TimeSeriesStore", "fraction_le"]

# A store that outlives its scrape targets must not grow without bound:
# past this many distinct series, new ones are counted and dropped.
DEFAULT_MAX_SERIES = 4096


def _series_key(name: str, labels: dict | None) -> tuple:
    return (name, tuple(sorted((labels or {}).items())))


def _hist_state_from_sample(sample: dict):
    """Mergeable histogram sample -> ``(bounds, state)`` where ``state``
    is the registry's ``snapshot_state()`` tuple ``(per-bucket counts,
    sum, count, inf_sum)``.

    The wire format carries cumulative counts and no ``inf_sum`` (the
    mean of the open tail); the tail therefore interpolates to the last
    finite bound — the conservative estimate a remote series can
    support."""
    bkts = sample.get("buckets") or []
    if not bkts:
        return None
    bounds = tuple(float(b) for b, _ in bkts[:-1])
    cums = [int(c) for _, c in bkts]
    counts = [cums[0]] + [cums[i] - cums[i - 1]
                          for i in range(1, len(cums))]
    return bounds, (counts, float(sample.get("sum", 0.0)),
                    int(sample.get("count", 0)), 0.0)


def _window_summary(bounds: tuple, new_state: tuple,
                    prev_state: tuple | None) -> dict:
    """``Histogram.delta_since`` over two stored state tuples.

    Routed through a detached ``_HistogramChild`` so the bucket-wise
    subtraction, reset degradation and percentile interpolation are the
    registry's OWN code path, not a reimplementation that could drift."""
    child = _HistogramChild(bounds)
    counts, h_sum, h_count, inf_sum = new_state
    with child._lock:
        child._counts = list(counts)
        child._sum = float(h_sum)
        child._count = int(h_count)
        child._inf_sum = float(inf_sum)
    return child.delta_since(prev_state)


def _merge_hist_states(states: list) -> tuple | None:
    """Element-wise sum of same-bounds ``(bounds, state)`` pairs — the
    cross-host aggregate; ``None`` on bound conflict (the merge.py
    rule: silently adding mismatched buckets corrupts percentiles)."""
    if not states:
        return None
    bounds = states[0][0]
    if any(b != bounds for b, _ in states[1:]):
        return None
    counts = [0] * len(states[0][1][0])
    h_sum = h_count = inf_sum = 0.0
    for _, (c, s, n, inf) in states:
        if len(c) != len(counts):
            return None
        counts = [a + b for a, b in zip(counts, c)]
        h_sum += s
        h_count += n
        inf_sum += inf
    return bounds, (counts, h_sum, int(h_count), inf_sum)


def fraction_le(bounds: tuple, counts: list, threshold: float) -> float:
    """Estimated fraction of observations ``<= threshold`` from a
    per-bucket count vector (linear interpolation inside the bucket the
    threshold falls in — the same fixed-bucket estimator the registry's
    percentiles use, inverted).  1.0 on an empty window (no
    observations violated anything)."""
    total = sum(counts)
    if total <= 0:
        return 1.0
    good = 0.0
    prev_bound = 0.0
    for i, c in enumerate(counts):
        bound = bounds[i] if i < len(bounds) else float("inf")
        if threshold >= bound:
            good += c
        elif threshold > prev_bound:
            width = bound - prev_bound
            frac = ((threshold - prev_bound) / width) if width > 0 else 0.0
            good += c * frac
            break
        else:
            break
        prev_bound = bound
    return min(1.0, good / total)


class _Series:
    __slots__ = ("kind", "points")

    def __init__(self, kind: str, capacity: int):
        import collections

        self.kind = kind
        # (ts, value) for counter/gauge; (ts, (bounds, state)) histogram
        self.points = collections.deque(maxlen=capacity)


class TimeSeriesStore:
    """Bounded per-series ring of timestamped snapshot points."""

    def __init__(self, capacity: int = 512,
                 max_series: int = DEFAULT_MAX_SERIES,
                 clock=time.time):
        if capacity < 2:
            raise ValueError(
                f"capacity must be >= 2 (a window needs two edges), "
                f"got {capacity}")
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}  # guarded-by: _lock
        self.dropped_series = 0  # guarded-by: _lock

    # -- ingestion ------------------------------------------------------
    def ingest(self, samples: list, ts: float | None = None,
               source: dict | None = None) -> int:
        """Append one timestamped point per mergeable-format sample
        (``merge.registry_samples`` shape).  ``source`` labels are
        merged into every sample's labels — per-host series identity.
        Returns the number of points stored."""
        when = float(ts) if ts is not None else self._clock()
        stored = 0
        prepared = []
        for s in samples:
            labels = dict(s.get("labels") or {})
            if source:
                labels.update(source)
            kind = s.get("kind")
            if kind == "histogram":
                st = _hist_state_from_sample(s)
                if st is None:
                    continue
                prepared.append((_series_key(s["name"], labels),
                                 "histogram", st))
            elif kind in ("counter", "gauge"):
                prepared.append((_series_key(s["name"], labels), kind,
                                 float(s.get("value", 0.0))))
        with self._lock:
            for key, kind, point in prepared:
                ser = self._series.get(key)
                if ser is None:
                    if len(self._series) >= self.max_series:
                        self.dropped_series += 1
                        continue
                    ser = self._series[key] = _Series(kind, self.capacity)
                ser.points.append((when, point))
                stored += 1
        return stored

    def ingest_registry(self, registry=None, ts: float | None = None,
                        source: dict | None = None) -> int:
        """Convenience: snapshot a LIVE registry into the store (the
        local, non-federated feed)."""
        from analytics_zoo_tpu_torch.metrics.merge import registry_samples

        return self.ingest(registry_samples(registry), ts=ts,
                           source=source)

    def observe(self, name: str, value: float, kind: str = "gauge",
                labels: dict | None = None, ts: float | None = None):
        """Append one scalar point directly (gauge/counter) — the
        supervisor's heartbeat-age feed, which has no registry sample
        behind it."""
        self.ingest([{"name": name, "kind": kind, "value": float(value),
                      **({"labels": labels} if labels else {})}], ts=ts)

    # -- introspection --------------------------------------------------
    def series(self) -> dict:
        """``{rendered_key: {"kind", "points", "newest_ts"}}``."""
        with self._lock:
            items = list(self._series.items())
        out = {}
        for (name, labels), ser in items:
            key = name if not labels else "%s{%s}" % (
                name, ",".join(f"{k}={v}" for k, v in labels))
            newest = ser.points[-1][0] if ser.points else None
            out[key] = {"kind": ser.kind, "points": len(ser.points),
                        "newest_ts": newest}
        return out

    def label_sets(self, name: str) -> list[dict]:
        with self._lock:
            keys = [k for k in self._series if k[0] == name]
        return [dict(labels) for _, labels in keys]

    def _select(self, name: str, labels: dict | None) -> list[_Series]:
        """Matching series under the lock-free read contract: exact
        label match when given, every series of the family when None."""
        with self._lock:
            if labels is not None:
                ser = self._series.get(_series_key(name, labels))
                return [ser] if ser is not None else []
            return [ser for (n, _), ser in self._series.items()
                    if n == name]

    @staticmethod
    def _window_points(ser: _Series, start: float) -> list:
        # deques are append-only here; a snapshot list is race-free
        return [p for p in list(ser.points) if p[0] >= start]

    # -- queries --------------------------------------------------------
    def rate(self, name: str, window: float,
             labels: dict | None = None, now: float | None = None) -> float:
        """Counter increase per second over the trailing ``window``
        (summed across series when ``labels`` is None).  A counter
        reset mid-window degrades to the newest value over the elapsed
        time — increase can never be negative."""
        t = now if now is not None else self._clock()
        total = 0.0
        for ser in self._select(name, labels):
            pts = self._window_points(ser, t - window)
            if len(pts) < 2:
                continue
            (t0, v0), (t1, v1) = pts[0], pts[-1]
            if t1 <= t0:
                continue
            inc = (v1 - v0) if v1 >= v0 else v1
            total += max(0.0, inc) / (t1 - t0)
        return total

    def window_summary(self, name: str, window: float,
                       labels: dict | None = None,
                       now: float | None = None) -> dict:
        """Histogram distribution over ONLY the window:
        ``{count, sum, mean, p50, p95, p99}`` via the registry's
        ``delta_since`` between the window's edge states.  Aggregates
        across series when ``labels`` is None (bound conflicts keep
        per-series windows out of the merge, the merge.py rule).
        Returns a zero summary when the window has no two edges."""
        t = now if now is not None else self._clock()
        edges = []
        for ser in self._select(name, labels):
            if ser.kind != "histogram":
                continue
            pts = self._window_points(ser, t - window)
            if not pts:
                continue
            # window edges: oldest in-window state is the baseline; a
            # series younger than the window uses its first point ever
            # recorded (count since birth — no pre-history to subtract)
            edges.append((pts[0][1], pts[-1][1]))
        if not edges:
            return {"count": 0, "sum": 0.0, "mean": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        merged_new = _merge_hist_states([new for _, new in edges])
        merged_old = _merge_hist_states([old for old, _ in edges])
        if merged_new is None or merged_old is None:
            # bound conflict across hosts: fall back to the largest
            # single series rather than corrupting the percentiles
            old, new = max(edges, key=lambda e: e[1][1][2])
            return _window_summary(new[0], new[1], old[1])
        return _window_summary(merged_new[0], merged_new[1],
                               merged_old[1])

    def percentile_over(self, name: str, q: float, window: float,
                        labels: dict | None = None,
                        now: float | None = None) -> float:
        """One window-local quantile (0.99 for a p99-over-30s)."""
        key = "p%d" % round(q * 100)
        summ = self.window_summary(name, window, labels=labels, now=now)
        if key in summ:
            return summ[key]
        # delta_since summaries carry exactly p50/p95/p99 — the set the
        # registry computes; anything else would be a silent estimate
        raise ValueError(
            f"percentile_over supports q in {{0.5, 0.95, 0.99}}, "
            f"got {q}")

    def bad_fraction(self, name: str, threshold: float, window: float,
                     labels: dict | None = None,
                     now: float | None = None) -> tuple[float, int]:
        """``(violating_fraction, samples)`` over the window.

        Histogram series: fraction of window observations above the
        threshold (bucket interpolation).  Gauge series: fraction of
        window POINTS above the threshold — the freshness/ceiling SLO
        shape (heartbeat age, memory ratio).  Counters have no
        threshold semantics and contribute nothing."""
        t = now if now is not None else self._clock()
        good = 0.0
        total = 0
        for ser in self._select(name, labels):
            pts = self._window_points(ser, t - window)
            if not pts:
                continue
            if ser.kind == "histogram":
                bounds, new = pts[-1][1]
                old = pts[0][1][1]
                d = [c - p for c, p in zip(new[0], old[0])]
                if any(x < 0 for x in d):
                    d = list(new[0])  # reset mid-window: full state
                n = sum(d)
                if n <= 0:
                    continue
                good += fraction_le(bounds, d, threshold) * n
                total += n
            elif ser.kind == "gauge":
                vals = [v for _, v in pts]
                good += sum(1 for v in vals if v <= threshold)
                total += len(vals)
        if total <= 0:
            return 0.0, 0
        return max(0.0, 1.0 - good / total), total

    def burn_rate(self, name: str, threshold: float, objective: float,
                  window: float, labels: dict | None = None,
                  now: float | None = None) -> float:
        """Error-budget burn over the window: ``bad_fraction / (1 -
        objective)``.  1.0 = violating exactly as often as the SLO
        allows; an alert rule fires on a multiple of it (slo.py).
        0.0 when the window holds no samples — no data is not a
        violation (the scrape-staleness SLO covers silent hosts)."""
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}")
        bad, n = self.bad_fraction(name, threshold, window,
                                   labels=labels, now=now)
        if n == 0:
            return 0.0
        return bad / (1.0 - objective)
