"""``analytics_zoo_tpu_torch.metrics``: the observability plane.

Counterpart of ``analytics_zoo_tpu/metrics``, with the same metric
families, help strings, label names, buckets and flight-record fields,
so a dashboard or a test written against one package reads the other.
A process-global :class:`MetricsRegistry` of labeled
Counter/Gauge/Histogram families, a contextvar-nested :func:`span`
tracer exporting Chrome-trace JSON, and exporters for Prometheus text,
JSONL and the port's TensorBoard writers.  Instrumented by default in
the estimator's fit loop (`zoo_train_*`), Cluster Serving
(`zoo_serving_*`) and pooled inference (`zoo_inference_*`); disable with
``ZOO_METRICS=0`` / ``ZOO_TRACE=0`` (then every recording call is a
shared no-op).  Every recording call is host-side work: the captured
steps and requests it wraps replay a CUDA graph, and nothing records
inside a capture.

:class:`MetricsServer` serves ``/metrics`` ``/varz`` ``/trace``
``/healthz`` ``/flightz`` ``/telemetryz`` ``/alertz`` over HTTP (opt-in
via ``ZOO_METRICS_PORT``); :mod:`merge` defines the mergeable
cross-process snapshot format and :class:`TelemetryAggregator`;
:mod:`health` is the component-heartbeat registry behind ``/healthz``;
:mod:`flight` is the bounded crash flight recorder dumped to
``ZOO_FLIGHT_DIR`` on exit/SIGTERM/crash.

The federation plane: :class:`VarzScraper` pulls every host's
``/telemetryz`` into the :class:`TelemetryAggregator` and a
:class:`TimeSeriesStore` of windowed history, and an :class:`SloEngine`
evaluates declarative :class:`SloSpec` objectives into multi-window
burn-rate alerts (``/alertz``) that the federated ``SloScaler`` and the
admission controller read.
"""


from analytics_zoo_tpu_torch.metrics.exporters import (
    JsonlExporter,
    TensorBoardExporter,
    prometheus_text,
    sample_key,
    sanitize_label_name,
    sanitize_metric_name,
    snapshot,
    write_jsonl,
)
from analytics_zoo_tpu_torch.metrics.flight import (
    FlightRecorder,
    StragglerBoard,
    StragglerDetector,
    get_flight_recorder,
    register_predump_hook,
    set_flight_recorder,
)
from analytics_zoo_tpu_torch.metrics.health import (
    HealthRegistry,
    get_health,
    set_health,
)
from analytics_zoo_tpu_torch.metrics.http import (
    MetricsServer,
    maybe_start_from_env,
)
from analytics_zoo_tpu_torch.metrics.merge import (
    TelemetryAggregator,
    merge_samples,
    telemetry_snapshot,
)
from analytics_zoo_tpu_torch.metrics.registry import (
    DEFAULT_BUCKETS,
    NULL,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullMetric,
    get_registry,
    set_registry,
)
from analytics_zoo_tpu_torch.metrics.runtime import (
    AdmissionMetrics,
    AutotuneMetrics,
    DataPipelineMetrics,
    ElasticMetrics,
    FleetMetrics,
    OracleMetrics,
    RouterMetrics,
    ScrapeMetrics,
    ServingMetrics,
    SloMetrics,
    StepMetrics,
    record_device_memory,
)
from analytics_zoo_tpu_torch.metrics.scrape import (
    VarzScraper,
    fleet_varz_targets,
)
from analytics_zoo_tpu_torch.metrics.slo import (
    SloEngine,
    SloSpec,
    default_slos,
)
from analytics_zoo_tpu_torch.metrics.timeseries import (
    TimeSeriesStore,
)
from analytics_zoo_tpu_torch.metrics.tracing import (
    Tracer,
    get_tracer,
    set_tracer,
    span,
)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "NullMetric",
    "NULL", "DEFAULT_BUCKETS", "get_registry", "set_registry",
    "Tracer", "span", "get_tracer", "set_tracer",
    "prometheus_text", "snapshot", "sample_key", "JsonlExporter",
    "write_jsonl", "TensorBoardExporter",
    "sanitize_metric_name", "sanitize_label_name",
    "StepMetrics", "ServingMetrics", "DataPipelineMetrics",
    "AutotuneMetrics", "FleetMetrics", "OracleMetrics",
    "ElasticMetrics", "ScrapeMetrics", "SloMetrics",
    "RouterMetrics", "AdmissionMetrics",
    "record_device_memory",
    "MetricsServer", "maybe_start_from_env",
    "TelemetryAggregator", "telemetry_snapshot", "merge_samples",
    "HealthRegistry", "get_health", "set_health",
    "FlightRecorder", "StragglerDetector", "StragglerBoard",
    "get_flight_recorder", "set_flight_recorder",
    "register_predump_hook",
    "TimeSeriesStore", "SloSpec", "SloEngine", "default_slos",
    "VarzScraper", "fleet_varz_targets",
]
