"""Per-model serving specs — the multi-tenant config surface
(counterpart of ``analytics_zoo_tpu/serving/modelspec.py``).

``ZOO_SERVING_MODELS`` declares the models one router serves, each
with its own SLO (and optionally the offered rate the oracle sizes the
fleet for)::

    ZOO_SERVING_MODELS="resnet=250@120,bert=500@30"

i.e. comma-separated ``name=slo_p99_ms[@offered_rate]`` entries.  Each
model gets its OWN input stream on the shared broker
(:func:`~analytics_zoo_tpu_torch.serving.client.model_stream`), its own
lease/pad-bucket/batch-budget config, and its own
``zoo_fleet_*{model=}`` telemetry — the router
(:mod:`analytics_zoo_tpu_torch.serving.router`) runs one fleet per spec.

Pure stdlib on purpose: client processes route by model without
pulling in torch.  Every parse error
names the source (the env var by default) — the eager-validation
contract.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelSpec", "parse_model_specs", "format_model_specs"]

_DEF_SOURCE = "ZOO_SERVING_MODELS"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One routed model: its name, p99 SLO, and (optional) the offered
    request rate the oracle's replica math sizes for (0.0 = unknown —
    the scaler's reactive policy owns sizing alone)."""

    name: str
    slo_p99_ms: float
    offered_rate: float = 0.0

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)


def _fail(source: str, raw: str, why: str) -> None:
    raise ValueError(
        f"{source} must be comma-separated "
        f"name=slo_p99_ms[@offered_rate] entries "
        f"(e.g. \"resnet=250@120,bert=500\"); got {raw!r}: {why}")


def parse_model_specs(raw: str, source: str = _DEF_SOURCE,
                      ) -> list[ModelSpec]:
    """Parse a ``ZOO_SERVING_MODELS``-shaped string into specs.

    Empty/None input parses to ``[]`` (single-tenant serving — the
    router is not in play).  Malformed entries raise ``ValueError``
    naming ``source`` so a bad env var fails at ZooConfig construction,
    not at the first routed request."""
    if raw is None or not str(raw).strip():
        return []
    raw = str(raw)
    specs: list[ModelSpec] = []
    seen: set[str] = set()
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, rest = entry.partition("=")
        name = name.strip()
        if not sep or not name:
            _fail(source, raw, f"entry {entry!r} lacks name=slo")
        if any(c in name for c in " \t:/"):
            # the name becomes a stream key + a metric label value
            _fail(source, raw,
                  f"model name {name!r} may not contain spaces, ':' "
                  f"or '/'")
        if name in seen:
            _fail(source, raw, f"duplicate model {name!r}")
        seen.add(name)
        slo_part, _, rate_part = rest.partition("@")
        try:
            slo = float(slo_part)
        except (TypeError, ValueError):
            _fail(source, raw,
                  f"slo_p99_ms of {name!r} must be a number, got "
                  f"{slo_part!r}")
        if slo <= 0:
            _fail(source, raw,
                  f"slo_p99_ms of {name!r} must be > 0, got {slo}")
        rate = 0.0
        if rate_part.strip():
            try:
                rate = float(rate_part)
            except (TypeError, ValueError):
                _fail(source, raw,
                      f"offered_rate of {name!r} must be a number, got "
                      f"{rate_part!r}")
            if rate < 0:
                _fail(source, raw,
                      f"offered_rate of {name!r} must be >= 0, got "
                      f"{rate}")
        specs.append(ModelSpec(name=name, slo_p99_ms=slo,
                               offered_rate=rate))
    if not specs:
        _fail(source, raw, "no entries")
    return specs


def format_model_specs(specs) -> str:
    """Inverse of :func:`parse_model_specs` — the string a subprocess
    replica/controller can be handed through the env."""
    parts = []
    for s in specs:
        part = f"{s.name}={s.slo_p99_ms:g}"
        if s.offered_rate:
            part += f"@{s.offered_rate:g}"
        parts.append(part)
    return ",".join(parts)
