"""Exporters: Prometheus text exposition, JSONL append, TensorBoard bridge.

One registry snapshot, three render targets:

- :func:`prometheus_text` — the `text exposition format
  <https://prometheus.io/docs/instrumenting/exposition_formats/>`_ a
  scraper (or a human with curl) reads; histograms expose cumulative
  ``_bucket{le=...}`` series plus ``_sum``/``_count``.
- :class:`JsonlExporter` / :func:`write_jsonl` — append one JSON object
  per snapshot to a file; ``tools/metrics_dump.py`` renders these into a
  latency/throughput table.
- :class:`TensorBoardExporter` — bridge into the existing event-file
  writers (:mod:`analytics_zoo_tpu_torch.tensorboard.writer`): every sample
  becomes an ``add_scalar`` so serving/estimator telemetry lands next to
  the Loss/Throughput curves already written there.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import time

from analytics_zoo_tpu_torch.metrics.registry import (
    MetricsRegistry,
    get_registry,
)

__all__ = [
    "prometheus_text", "JsonlExporter", "write_jsonl",
    "TensorBoardExporter", "sample_key",
    "sanitize_metric_name", "sanitize_label_name",
    "unique_exposition_names",
]

# Prometheus charsets: metric names allow colons, label names do not.
_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


@functools.lru_cache(maxsize=1024)
def sanitize_metric_name(name: str) -> str:
    """Map an arbitrary registry name onto the Prometheus metric-name
    charset (``[a-zA-Z_:][a-zA-Z0-9_:]*``): dots and other invalid
    characters become underscores; a leading digit gets a ``_`` prefix.
    Valid names pass through unchanged (the common case — cached so the
    exposition hot path pays one dict lookup, not a regex pass)."""
    if _METRIC_NAME_RE.match(name):
        return name
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not re.match(r"[a-zA-Z_:]", out[0]):
        out = "_" + out
    return out


@functools.lru_cache(maxsize=1024)
def sanitize_label_name(name: str) -> str:
    """Label-name variant (``[a-zA-Z_][a-zA-Z0-9_]*`` — no colons)."""
    if _LABEL_NAME_RE.match(name):
        return name
    out = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if not out or not re.match(r"[a-zA-Z_]", out[0]):
        out = "_" + out
    return out


def unique_exposition_names(names) -> dict:
    """raw family name -> COLLISION-FREE sanitized exposition name.

    Two distinct registry names can sanitize to the same string
    (``zoo.lat.seconds`` vs ``zoo_lat_seconds``); emitting both under
    one name would produce duplicate ``# TYPE`` blocks and make a
    Prometheus parser reject the whole scrape body.  The later name (in
    iteration order) gets a deterministic crc32 suffix instead — stable
    across processes and scrapes, unlike ``hash()``."""
    import zlib

    out: dict = {}
    owner: dict = {}
    for raw in names:
        s = sanitize_metric_name(raw)
        if owner.get(s, raw) != raw:
            s = f"{s}_x{zlib.crc32(raw.encode()) & 0xFFFFFFFF:08x}"
        owner[s] = raw
        out[raw] = s
    return out


def sample_key(sample: dict) -> str:
    """Canonical flat key for one :func:`snapshot` sample —
    ``name`` or ``name{label=value,...}`` — shared by every consumer
    that needs a dict key per labeled series (``tools/metrics_dump.py``,
    ``tools/serving_bench.py``), so the two JSON outputs agree."""
    labels = sample.get("labels")
    if not labels:
        return sample["name"]
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{sample['name']}{{{inner}}}"


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace(
        '"', r'\"')


def _label_str(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    # collision-free label names: two raw keys sanitizing to one name
    # ("a.b" and "a_b") would render a duplicate label inside one
    # sample, which the Prometheus parser rejects wholesale — same
    # crc32-suffix rule as unique_exposition_names
    import zlib

    parts = []
    owner: dict = {}
    for k, v in sorted(items.items()):
        name = sanitize_label_name(k)
        if owner.get(name, k) != k:
            name = f"{name}_x{zlib.crc32(k.encode()) & 0xFFFFFFFF:08x}"
        owner[name] = k
        parts.append(f'{name}="{_escape_label(v)}"')
    return "{" + ",".join(parts) + "}"


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    """Render a registry snapshot in Prometheus text exposition format."""
    reg = registry if registry is not None else get_registry()
    lines: list[str] = []
    families = reg.collect()
    # registry names are unconstrained (dots are natural for spans); the
    # EXPOSITION must stay inside the Prometheus charset — and stay
    # collision-free after mapping — or the scraper rejects the whole body
    names = unique_exposition_names(f.name for f in families)
    for fam in families:
        name = names[fam.name]
        if fam.help:
            lines.append(f"# HELP {name} {fam.help}")
        lines.append(f"# TYPE {name} {fam.kind}")
        for labels, child in fam.samples():
            if fam.kind == "histogram":
                # one snapshot for buckets AND sum/count: the exposition
                # must satisfy _bucket{le="+Inf"} == _count even with
                # concurrent observes mid-scrape
                bkts, h_sum, h_count = child.export_state()
                for bound, cum in bkts:
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(labels, {'le': _fmt(bound)})}"
                        f" {cum}")
                lines.append(
                    f"{name}_sum{_label_str(labels)}"
                    f" {_fmt(h_sum)}")
                lines.append(
                    f"{name}_count{_label_str(labels)} {h_count}")
            else:
                lines.append(
                    f"{name}{_label_str(labels)} {_fmt(child.get())}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot(registry: MetricsRegistry | None = None,
             step: int | None = None) -> dict:
    """One registry snapshot as a plain JSON-able dict — the JSONL line
    shape (also what ``bench.py`` embeds in its result line)."""
    reg = registry if registry is not None else get_registry()
    samples = []
    for fam in reg.collect():
        for labels, child in fam.samples():
            s = {"name": fam.name, "kind": fam.kind}
            if labels:
                s["labels"] = labels
            if fam.kind == "histogram":
                s.update(child.summary())
            else:
                s["value"] = child.get()
            samples.append(s)
    doc = {"ts": time.time(), "samples": samples}
    if step is not None:
        doc["step"] = int(step)
    return doc


class JsonlExporter:
    """Append registry snapshots to a JSONL file (one object per line)."""

    def __init__(self, path: str,
                 registry: MetricsRegistry | None = None):
        self.path = path
        self._registry = registry
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, step: int | None = None) -> dict:
        doc = snapshot(self._registry, step=step)
        with open(self.path, "a") as f:
            f.write(json.dumps(doc) + "\n")
        return doc


def write_jsonl(path: str, registry: MetricsRegistry | None = None,
                step: int | None = None) -> dict:
    """One-shot :class:`JsonlExporter` append."""
    return JsonlExporter(path, registry).write(step=step)


class TensorBoardExporter:
    """Bridge a registry snapshot into an event-file writer.

    ``writer`` is anything with ``add_scalar(tag, value, step)`` — a
    :class:`~analytics_zoo_tpu_torch.tensorboard.writer.FileWriter` or any of
    the TrainSummary/ValidationSummary/InferenceSummary wrappers.
    Histograms export their summary as ``<name>/p50`` etc. (event files
    carry scalars; the full bucket vector stays in Prometheus/JSONL).
    """

    def __init__(self, writer, registry: MetricsRegistry | None = None):
        self._writer = writer
        self._registry = registry

    def export(self, step: int) -> int:
        """Write every sample at ``step``; returns #scalars written."""
        reg = (self._registry if self._registry is not None
               else get_registry())
        n = 0
        for fam in reg.collect():
            for labels, child in fam.samples():
                tag = fam.name + _label_str(labels)
                if fam.kind == "histogram":
                    for k, v in child.summary().items():
                        self._writer.add_scalar(f"{tag}/{k}", v, step)
                        n += 1
                else:
                    self._writer.add_scalar(tag, child.get(), step)
                    n += 1
        return n
