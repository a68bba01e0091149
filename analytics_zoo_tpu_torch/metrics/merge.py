"""Mergeable telemetry snapshots + cross-process aggregation.

The distributed half of the registry: every actor-worker and
spawned-actor process accumulates its own :class:`MetricsRegistry`; this
module defines the *snapshot* format those processes ship over the
``__zoo_telemetry__`` control frame (parallel/actors.py) and the
aggregating :class:`TelemetryAggregator` that folds snapshots from many
sources into one pod-level view.

Snapshot format (:func:`telemetry_snapshot`) — a plain JSON-able dict,
built on the registry's existing export primitives (``child.get()`` for
counters/gauges, ``_HistogramChild.export_state()`` for the cumulative
bucket vector), so a snapshot carries FULL mergeable state, not lossy
p50/p95 summaries::

    {"ts": ..., "pid": ..., "host": ..., "health": {...},
     "samples": [
       {"name", "kind", "help", "labels"?, "value"},            # ctr/gauge
       {"name", "kind", "help", "labels"?,                      # histogram
        "buckets": [[le, cum], ..., [None, total]],             # None = +Inf
        "sum": ..., "count": ...},
     ]}

Merge semantics (the Prometheus aggregation rules):

- **counters sum** across sources — 3 actors that each served 100
  records are a pod that served 300;
- **gauges keep per-source labeled series** — queue depths and memory
  ratios from different hosts must not be added;
- **histograms merge bucket-wise** (element-wise cumulative-count sum,
  sums and counts added) when bucket bounds agree; sources with
  conflicting bounds stay per-source only (silently adding mismatched
  buckets would corrupt every percentile — same rule as the registry's
  explicit-bucket conflict check).

The aggregator keeps ingested snapshots *alongside* the aggregating
process's registry (not folded into it): re-ingesting a fresh pull from the same source
REPLACES its series, which a fold-into-counters design cannot express.
``merged()`` returns both the per-source labeled series and the
cluster totals; ``prometheus_text()`` renders the per-source series in
exposition format for ``/metrics`` (scrapers sum; humans read totals
from ``/varz``).

Staleness: a source that stops re-ingesting is never
evicted — its last snapshot stays in the rollup so a dead host remains
VISIBLE — but once its last ingest is older than ``stale_after``
seconds it is flagged: ``sources()`` reports ``stale: true`` +
``age_seconds``, and ``labeled_samples()`` adds a ``stale="true"``
label to its series so dashboards and the federation scraper can
filter it without losing it.  Totals keep stale contributions (a dead
host's counters are its true last-known work; dropping them would make
pod totals dip on every death) — the per-source flags carry the
verdict.
"""

from __future__ import annotations

import math
import os
import socket
import threading
import time

from analytics_zoo_tpu_torch.metrics.registry import (
    MetricsRegistry,
    get_registry,
)

__all__ = ["telemetry_snapshot", "registry_samples", "merge_samples",
           "samples_to_prometheus", "TelemetryAggregator"]


def registry_samples(registry: MetricsRegistry | None = None) -> list[dict]:
    """One registry's families in the mergeable sample format (the
    ``samples`` list of :func:`telemetry_snapshot`)."""
    reg = registry if registry is not None else get_registry()
    samples = []
    for fam in reg.collect():
        for labels, child in fam.samples():
            s = {"name": fam.name, "kind": fam.kind, "help": fam.help}
            if labels:
                s["labels"] = labels
            if fam.kind == "histogram":
                bkts, h_sum, h_count = child.export_state()
                # +Inf encoded as None: the snapshot crosses JSON
                # boundaries (/varz consumers), where Infinity is not
                # valid strict JSON
                s["buckets"] = [
                    [None if math.isinf(b) else b, cum]
                    for b, cum in bkts]
                s["sum"] = h_sum
                s["count"] = h_count
            else:
                s["value"] = child.get()
            samples.append(s)
    return samples


def telemetry_snapshot(registry: MetricsRegistry | None = None,
                       health=None) -> dict:
    """Full mergeable state of one process: registry + health rollup."""
    if health is None:
        from analytics_zoo_tpu_torch.metrics.health import get_health

        health = get_health()
    return {
        "ts": time.time(),
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "health": health.status(),
        "samples": registry_samples(registry),
    }


def _series_key(sample: dict) -> tuple:
    """(name, sorted orig labels) — the cross-source merge identity."""
    return (sample["name"],
            tuple(sorted((sample.get("labels") or {}).items())))


def _merge_group(samples: list[dict]) -> dict | None:
    """Merge same-series samples from different sources into one total.

    Counters sum; histograms merge bucket-wise (None on bound
    conflict); gauges return None (no meaningful cross-source total).
    """
    kind = samples[0]["kind"]
    out = {k: v for k, v in samples[0].items() if k in
           ("name", "kind", "help", "labels")}
    if kind == "counter":
        out["value"] = sum(s.get("value", 0.0) for s in samples)
        return out
    if kind == "histogram":
        bounds = [tuple(b for b, _ in s["buckets"]) for s in samples]
        if any(b != bounds[0] for b in bounds[1:]):
            return None  # conflicting bounds: per-source series only
        out["buckets"] = [
            [bound, sum(s["buckets"][i][1] for s in samples)]
            for i, (bound, _) in enumerate(samples[0]["buckets"])]
        out["sum"] = sum(s.get("sum", 0.0) for s in samples)
        out["count"] = sum(s.get("count", 0) for s in samples)
        return out
    return None  # gauge


def merge_samples(sample_lists: list[list[dict]]) -> list[dict]:
    """Cluster totals across N sources' sample lists (see module doc)."""
    groups: dict[tuple, list[dict]] = {}
    for samples in sample_lists:
        for s in samples:
            groups.setdefault(_series_key(s), []).append(s)
    out = []
    for key in sorted(groups):
        merged = _merge_group(groups[key])
        if merged is not None:
            out.append(merged)
    return out


class TelemetryAggregator:
    """The aggregating process's pod view: latest snapshot per source,
    merged on read.

    ``ingest(snap, host=..., actor=...)`` labels every series from that
    snapshot with the given source labels; the (sorted) label set IS the
    source identity, so a fresh pull from the same actor replaces its
    previous snapshot instead of double-counting it.
    """

    #: default seconds-without-ingest before a source is flagged stale
    DEFAULT_STALE_AFTER = 15.0

    def __init__(self, registry: MetricsRegistry | None = None,
                 stale_after: float | None = None):
        self._registry = registry
        self.stale_after = (float(stale_after) if stale_after is not None
                            else self.DEFAULT_STALE_AFTER)
        self._lock = threading.Lock()
        # key -> (source_labels, snapshot, ingest_time)
        self._sources: dict[tuple, tuple[dict, dict, float]] = {}  # guarded-by: _lock

    def ingest(self, snap: dict, **source_labels) -> tuple:
        if not source_labels:
            raise ValueError(
                "ingest() needs at least one source label (host=/actor=) "
                "— unlabeled snapshots from two sources would collide")
        key = tuple(sorted(
            (k, str(v)) for k, v in source_labels.items()))
        with self._lock:
            self._sources[key] = (dict(key), snap, time.time())
        return key

    def sources(self) -> dict:
        now = time.time()
        with self._lock:
            items = list(self._sources.items())
        return {
            ",".join(f"{k}={v}" for k, v in key): {
                "labels": labels,
                "ts": snap.get("ts"),
                "host": snap.get("host"),
                "pid": snap.get("pid"),
                "healthy": (snap.get("health") or {}).get("healthy"),
                "ingested": ingested,
                "age_seconds": round(now - ingested, 3),
                "stale": (now - ingested) > self.stale_after,
            }
            for key, (labels, snap, ingested) in items
        }

    def stale_sources(self) -> list[str]:
        """Rendered keys of sources past the stale threshold."""
        return [k for k, v in self.sources().items() if v["stale"]]

    def labeled_samples(self) -> list[dict]:
        """Every source's samples with its source labels merged in; a
        source past ``stale_after`` additionally gets ``stale="true"``
        (visible-but-flagged — never evicted)."""
        now = time.time()
        with self._lock:
            items = list(self._sources.values())
        out = []
        for labels, snap, ingested in items:
            stale = (now - ingested) > self.stale_after
            for s in snap.get("samples", []):
                ls = dict(s.get("labels") or {})
                ls.update(labels)
                if stale:
                    ls["stale"] = "true"
                out.append({**s, "labels": ls})
        return out

    def merged(self, include_driver: bool = True) -> dict:
        """The pod-level doc served at ``/varz`` on an aggregating
        process: per-source labeled series, cluster totals, source and
        health inventory — plus that process's own registry alongside
        (the ``driver`` key, the reference's name)."""
        with self._lock:
            items = list(self._sources.values())
        doc = {
            "ts": time.time(),
            "sources": self.sources(),
            "samples": self.labeled_samples(),
            "totals": merge_samples(
                [snap.get("samples", []) for _, snap, _ in items]),
        }
        if include_driver:
            reg = (self._registry if self._registry is not None
                   else get_registry())
            doc["driver"] = telemetry_snapshot(reg)
        return doc

    def prometheus_text(self) -> str:
        """Per-source series in exposition format.  NOTE: the
        aggregating process's ``/metrics`` does NOT concatenate this with
        ``exporters.prometheus_text`` — two renders of a shared family
        name would emit duplicate ``# TYPE`` blocks, which a Prometheus
        parser rejects wholesale; it feeds own + source samples
        through ONE :func:`samples_to_prometheus` pass instead."""
        return samples_to_prometheus(self.labeled_samples())


def samples_to_prometheus(samples: list[dict]) -> str:
    """Render snapshot-format samples as Prometheus exposition text
    (same sanitization/escaping/collision rules as
    ``exporters.prometheus_text``, which renders live registries).
    Samples sharing a name render as ONE family group with one ``TYPE``
    line, regardless of which source they came from."""
    from analytics_zoo_tpu_torch.metrics.exporters import (
        _fmt,
        _label_str,
        unique_exposition_names,
    )

    by_name: dict[str, list[dict]] = {}
    for s in samples:
        by_name.setdefault(s["name"], []).append(s)
    names = unique_exposition_names(sorted(by_name))
    lines: list[str] = []
    for name in sorted(by_name):
        group = by_name[name]
        pname = names[name]
        if group[0].get("help"):
            lines.append(f"# HELP {pname} {group[0]['help']}")
        lines.append(f"# TYPE {pname} {group[0]['kind']}")
        for s in group:
            labels = s.get("labels") or {}
            if s["kind"] == "histogram":
                for bound, cum in s.get("buckets", []):
                    le = "+Inf" if bound is None else _fmt(float(bound))
                    lines.append(
                        f"{pname}_bucket"
                        f"{_label_str(labels, {'le': le})} {cum}")
                lines.append(
                    f"{pname}_sum{_label_str(labels)}"
                    f" {_fmt(s.get('sum', 0.0))}")
                lines.append(
                    f"{pname}_count{_label_str(labels)}"
                    f" {int(s.get('count', 0))}")
            else:
                lines.append(
                    f"{pname}{_label_str(labels)}"
                    f" {_fmt(s.get('value', 0.0))}")
    return "\n".join(lines) + ("\n" if lines else "")
