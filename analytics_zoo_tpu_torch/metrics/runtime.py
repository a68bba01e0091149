"""Runtime collectors: per-step breakdown and device-memory gauges.

The tf.data lesson (PAPERS.md: "tf.data: A Machine Learning Data
Processing Framework"): the data-wait vs. compute split must be measured
*inside* the framework, per step, not reconstructed per-benchmark.
:class:`StepMetrics` is that split for the estimator fit loop:

- ``data_wait``   — blocking on the infeed queue (host batch assembly +
  H2D dispatch the double-buffered feeder failed to hide);
- ``dispatch``    — handing the batch to the planned step (on the card a
  CUDA graph replay: host-side launch cost);
- ``step``        — one full loop iteration wall time (data_wait +
  dispatch + callback/trigger work; device compute overlaps it).

All three are histograms, so the exporters carry p50/p95/p99 — tail
behavior (a stalling input pipeline shows up as a fat data_wait p99 long
before it moves the mean).

:func:`record_device_memory` snapshots ``torch.cuda.memory_stats()`` of
each CUDA device this process has put memory on into the reference's
gauges (on a host with no CUDA device the collector is a silent no-op).

Counterpart of ``analytics_zoo_tpu/metrics/runtime.py``: the same
families, help strings, labels and buckets, letter for letter.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.metrics.registry import (
    DEFAULT_BUCKETS,
    MetricsRegistry,
    get_registry,
)

__all__ = ["StepMetrics", "ServingMetrics", "DataPipelineMetrics",
           "AutotuneMetrics", "FleetMetrics", "OracleMetrics",
           "ElasticMetrics", "ScrapeMetrics", "SloMetrics",
           "RouterMetrics", "AdmissionMetrics",
           "record_device_memory"]

# Step-time shaped buckets (seconds): the shared latency bounds minus
# the 30s tail — a 30s TRAIN step is not a resolution we need, and
# deriving (not copying) keeps the two tables in sync.
STEP_BUCKETS = DEFAULT_BUCKETS[:-1]

# Batch sizes are small integers; bound buckets cover 1..4096.
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


class StepMetrics:
    """Fit-loop breakdown recorder.

    Children are resolved ONCE at construction, so the per-step cost is
    three ``observe`` + two ``inc`` calls — and on a disabled registry
    every one of those is the shared no-op singleton (no allocation)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.data_wait = reg.histogram(
            "zoo_train_data_wait_seconds",
            "time blocked on the infeed queue per step",
            buckets=STEP_BUCKETS)
        self.dispatch = reg.histogram(
            "zoo_train_step_dispatch_seconds",
            "host-side jitted-step dispatch time per step",
            buckets=STEP_BUCKETS)
        self.step = reg.histogram(
            "zoo_train_step_seconds",
            "full loop-iteration wall time per step",
            buckets=STEP_BUCKETS)
        self.steps = reg.counter(
            "zoo_train_steps_total", "train steps dispatched")
        self.stragglers = reg.counter(
            "zoo_train_stragglers_total",
            "steps flagged by the flight recorder's straggler detector "
            "(> k x rolling p50)")
        self.records = reg.counter(
            "zoo_train_records_total", "training records consumed")
        self.throughput = reg.gauge(
            "zoo_train_throughput_records_per_sec",
            "end-to-end fit throughput, updated per epoch")
        self.epoch = reg.gauge("zoo_train_epoch", "current epoch")

    def record_step(self, data_wait_s: float, dispatch_s: float,
                    step_s: float, batch_size: int, steps: int = 1):
        """One loop iteration = one DISPATCH.  Under the fused multi-step
        path (``ZOO_STEPS_PER_DISPATCH=K``) a dispatch advances ``steps``
        optimizer steps and consumes ``batch_size`` records total, so the
        steps/records counters keep their K=1 meaning while the three
        histograms measure per-dispatch host cost (the quantity fusion
        amortizes)."""
        self.data_wait.observe(data_wait_s)
        self.dispatch.observe(dispatch_s)
        self.step.observe(step_s)
        self.steps.inc(steps)
        self.records.inc(batch_size)

    def record_epoch(self, epoch: int, throughput: float):
        self.epoch.set(epoch)
        self.throughput.set(throughput)


class ServingMetrics:
    """Cluster Serving telemetry (one instance per :class:`ClusterServing`).

    Gauges/histograms follow the queueing-system canon: offered depth,
    service batch size, end-to-end service latency, broker pressure."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        # callers gate work done ONLY to feed a metric (e.g. the extra
        # broker xlen round-trip for queue_depth) on this flag — the
        # NULL children silently discard values, but the side channel
        # that produced them is not free
        self.enabled = reg.enabled
        self.queue_depth = reg.gauge(
            "zoo_serving_queue_depth",
            "input-stream backlog after the poll")
        self.batch_size = reg.histogram(
            "zoo_serving_batch_size",
            "records per served micro-batch", buckets=BATCH_BUCKETS)
        self.latency = reg.histogram(
            "zoo_serving_step_latency_seconds",
            "decode -> predict -> write-back latency per non-empty step "
            "(poll/block wait excluded)")
        self.predict_latency = reg.histogram(
            "zoo_serving_predict_seconds",
            "model predict time per micro-batch group")
        self.records = reg.counter(
            "zoo_serving_records_total", "records served")
        self.trims = reg.counter(
            "zoo_serving_backpressure_trims_total",
            "backpressure stream cuts (ClusterServing.scala:128-134 role)")
        self.stragglers = reg.counter(
            "zoo_serving_stragglers_total",
            "serving cycles flagged > k x rolling p50 by the flight "
            "recorder's straggler detector")
        self.memory_ratio = reg.gauge(
            "zoo_serving_broker_memory_ratio",
            "broker used/max memory in [0,1]")


class DataPipelineMetrics:
    """Host data-plane telemetry (``zoo_data_prefetch_*``) for the
    parallel prefetch pipeline (feature/prefetch.py).

    The two histograms are the pipeline's diagnosis pair: a fat
    ``consumer_wait`` p99 means the pipeline is the bottleneck (raise
    ``workers``/``depth``); a fat ``producer_stall`` p99 means the
    CONSUMER (device step) is — the pipeline is keeping up and further
    workers buy nothing.  Queue occupancy sits between them: pinned at
    the depth limit is healthy, pinned at zero is starving."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.enabled = reg.enabled
        self.queue_depth = reg.gauge(
            "zoo_data_prefetch_queue_depth",
            "prefetch queue occupancy (batches ready or in flight)")
        self.depth_limit = reg.gauge(
            "zoo_data_prefetch_depth",
            "configured prefetch queue capacity")
        self.workers = reg.gauge(
            "zoo_data_prefetch_workers",
            "configured prefetch worker threads")
        self.producer_stall = reg.histogram(
            "zoo_data_prefetch_producer_stall_seconds",
            "time the producer blocked on a full prefetch queue per batch",
            buckets=STEP_BUCKETS)
        self.consumer_wait = reg.histogram(
            "zoo_data_prefetch_consumer_wait_seconds",
            "time the consumer blocked waiting for the next prefetched "
            "batch", buckets=STEP_BUCKETS)
        self.batches = reg.counter(
            "zoo_data_prefetch_batches_total",
            "batches delivered through the prefetch pipeline")
        self.errors = reg.counter(
            "zoo_data_prefetch_errors_total",
            "exceptions propagated through the prefetch pipeline")
        self.batch_bytes = reg.gauge(
            "zoo_data_prefetch_batch_bytes",
            "host bytes of the last delivered batch (the autotune "
            "RAM-budget estimator input: resident ≈ bytes x depth)")


class AutotuneMetrics:
    """Closed-loop autotuner telemetry (``zoo_autotune_*``,
    feature/autotune.py).

    Gauges mirror the controller's CURRENT knob values so a scrape shows
    what the pipeline is running with right now; the decision counter
    (labeled by knob and reason) is the tuning activity rate — a counter
    that keeps climbing long after warmup means the policy is
    oscillating, not converging.  The full structured decision log
    (time, knob, old→new, reason) is bounded in the controller and
    served at ``/varz`` under ``autotune``."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.enabled = reg.enabled
        self.workers = reg.gauge(
            "zoo_autotune_workers",
            "current autotuned prefetch worker-pool size")
        self.depth = reg.gauge(
            "zoo_autotune_depth",
            "current autotuned prefetch queue depth")
        self.read_ahead = reg.gauge(
            "zoo_autotune_read_ahead",
            "current autotuned shard read-ahead count")
        self.k = reg.gauge(
            "zoo_autotune_k",
            "current autotuned steps_per_dispatch (fused scan-K)")
        self.ram_budget = reg.gauge(
            "zoo_autotune_ram_budget_bytes",
            "configured host-RAM budget for the prefetch window")
        self.ram_estimate = reg.gauge(
            "zoo_autotune_ram_estimate_bytes",
            "estimated resident bytes of the prefetch window "
            "(batch bytes x (depth + workers) + read-ahead shards)")
        self.decisions = reg.counter(
            "zoo_autotune_decisions_total",
            "autotune knob changes, by knob and reason",
            labelnames=("knob", "reason"))


class OracleMetrics:
    """Predictive compile-plane telemetry (``zoo_oracle_*``,
    analysis/oracle.py).

    The family's job is the data-loop audit: every prediction the
    oracle hands a consumer (the autotuner's K prior, the estimator's
    ``plan="auto"``) is counted, and once the consumer measures the
    outcome the predicted/measured pair lands in per-config gauges with
    the relative error alongside — a scrape answers "is the model
    earning its priors" without replaying the run.  ``fit_samples`` is
    the residual model's training-set size (0 = pure analytic
    roofline, the <N-samples fallback)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.enabled = reg.enabled
        self.predictions = reg.counter(
            "zoo_oracle_predictions_total",
            "config predictions served, by consumer "
            "(autotune_k / plan_auto / rank)",
            labelnames=("consumer",))
        self.predicted_sps = reg.gauge(
            "zoo_oracle_predicted_steps_per_sec",
            "oracle-predicted steps/sec for the chosen config",
            labelnames=("config",))
        self.measured_sps = reg.gauge(
            "zoo_oracle_measured_steps_per_sec",
            "measured steps/sec reported back for a predicted config",
            labelnames=("config",))
        self.rel_error = reg.gauge(
            "zoo_oracle_prediction_rel_error",
            "|predicted - measured| / measured for the last "
            "prediction->outcome pair per config",
            labelnames=("config",))
        self.fit_samples = reg.gauge(
            "zoo_oracle_fit_samples",
            "training rows behind the residual model "
            "(0 = analytic-only fallback)")
        # predictive serving plane: the choose_serving
        # verdict per model — what the fleet was PRIMED with before the
        # first request, scored against measured predict latency the
        # same way every oracle pick is
        self.serving_predicted_seconds = reg.gauge(
            "zoo_serving_predicted_seconds",
            "oracle-predicted predict-step wall seconds per pad bucket",
            labelnames=("model", "bucket"))
        self.serving_predicted_replicas = reg.gauge(
            "zoo_serving_predicted_replicas",
            "oracle-predicted replica target for the offered rate",
            labelnames=("model",))
        self.serving_predicted_budget_ms = reg.gauge(
            "zoo_serving_predicted_batch_budget_ms",
            "oracle-picked continuous-batching budget per model",
            labelnames=("model",))


class FleetMetrics:
    """Serving-fleet control plane telemetry (``zoo_fleet_*``,
    serving/fleet.py + the claim-mode server loop).

    The replica-count pair (live vs target) is the autoscaler's visible
    state; the decision counter (labeled action/reason) is its activity
    rate — like ``zoo_autotune_decisions_total``, a counter still
    climbing long after a load change means the policy is oscillating.
    ``lease_takeovers`` is the fleet's fault-tolerance signal: nonzero
    means a replica died mid-batch and a survivor reclaimed its
    records (exactly-once via lease expiry).  ``est_p99_seconds`` is
    the scaler's own SLO estimate (predict p99 + Little's-law queue
    delay) so a scrape shows WHAT the scale decision saw."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.enabled = reg.enabled
        self.replicas = reg.gauge(
            "zoo_fleet_replicas", "live serving replicas")
        self.replicas_target = reg.gauge(
            "zoo_fleet_replicas_target",
            "autoscaler's current target replica count")
        self.decisions = reg.counter(
            "zoo_fleet_decisions_total",
            "autoscaler scale decisions, by action and reason",
            labelnames=("action", "reason"))
        self.lease_takeovers = reg.counter(
            "zoo_fleet_lease_takeovers_total",
            "expired-lease records reclaimed from dead replicas")
        self.replica_deaths = reg.counter(
            "zoo_fleet_replica_deaths_total",
            "replicas found dead by the controller's supervision pass")
        self.est_p99 = reg.gauge(
            "zoo_fleet_est_p99_seconds",
            "scaler's estimated request p99 over the last window "
            "(predict p99 + queue_depth / service_rate)")
        self.queue_depth = reg.gauge(
            "zoo_fleet_unclaimed_backlog",
            "unclaimed input-stream backlog at the last scaler tick "
            "(claimed in-flight work excluded)")
        self.slo_violations = reg.counter(
            "zoo_fleet_slo_violation_windows_total",
            "scaler windows whose estimated p99 violated the SLO")
        self.batch_flushes = reg.counter(
            "zoo_fleet_batch_flushes_total",
            "continuous-batching bucket flushes, by reason "
            "(full / budget / drain)", labelnames=("reason",))
        # federation tier: host dimension alongside replicas
        self.hosts = reg.gauge(
            "zoo_fleet_hosts",
            "live scrape-fresh hosts contributing federated signals")
        self.hosts_target = reg.gauge(
            "zoo_fleet_hosts_target",
            "scaler's host target from replicas-per-host packing "
            "(advisory — an external provisioner acts on it)")


class RouterMetrics:
    """Multi-tenant router telemetry (``zoo_router_*`` +
    per-model ``zoo_fleet_*{model=}``, serving/router.py).

    One ``ModelRouter`` supervises a heterogeneous set of per-model
    fleets; the model-labeled fleet trio (replicas / backlog /
    est p99) is the per-tenant view the unlabeled ``zoo_fleet_*``
    families cannot carry (two controllers on one registry would
    collide), and a merged scrape across hosts keeps the label — the
    zoowatch federation plane sees each tenant separately."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.enabled = reg.enabled
        self.models = reg.gauge(
            "zoo_router_models", "models currently routed")
        self.decisions = reg.counter(
            "zoo_router_decisions_total",
            "router control actions (prime / scale / stop), "
            "by model and action", labelnames=("model", "action"))
        self.replicas = reg.gauge(
            "zoo_fleet_model_replicas",
            "live serving replicas, by model", labelnames=("model",))
        self.backlog = reg.gauge(
            "zoo_fleet_model_backlog",
            "unclaimed per-model stream backlog at the last tick",
            labelnames=("model",))
        self.est_p99 = reg.gauge(
            "zoo_fleet_model_est_p99_seconds",
            "scaler's estimated request p99, by model",
            labelnames=("model",))


class AdmissionMetrics:
    """Front-door admission telemetry (``zoo_admission_*``,
    serving/admission.py).

    The accept/shed counter pair is the shedding audit: every enqueue
    verdict is counted by model, so `accepted == served` (the
    exactly-once audit) and the shed fraction under overload are both
    one scrape away.  ``state`` is the current verdict gauge (0 =
    accepting, 1 = shedding) and ``retry_after_seconds`` the hint the
    last shed carried — what a client backoff loop actually obeys."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.enabled = reg.enabled
        self.requests = reg.counter(
            "zoo_admission_requests_total",
            "front-door verdicts, by model and verdict (accept/shed)",
            labelnames=("model", "verdict"))
        self.state = reg.gauge(
            "zoo_admission_state",
            "current admission state (0 accepting, 1 shedding), "
            "by model", labelnames=("model",))
        self.retry_after = reg.gauge(
            "zoo_admission_retry_after_seconds",
            "retry-after hint carried by the latest shed verdict",
            labelnames=("model",))
        self.evaluations = reg.counter(
            "zoo_admission_evaluations_total",
            "admission re-evaluation ticks across all models")


class ElasticMetrics:
    """Elastic training-runtime telemetry (``zoo_elastic_*``,
    elastic/supervisor.py + membership.py).

    The generation/world pair is the membership ledger's visible state:
    generation increments on ANY join/leave, world size is the live
    member count the next training cohort runs at.  ``rejoins_total``
    (labeled by reason — worker_death / worker_join / below_min) is the
    supervisor's activity rate, the elastic analogue of
    ``zoo_fleet_decisions_total``.  ``steps_lost_total`` is the
    fault-tolerance cost signal: steps replayed from the last durable
    snapshot after an uncheckpointed death — zero while faults land on
    checkpoint boundaries.  ``rejoin_seconds`` is the gap from a
    generation change to the new cohort's first training step; it is
    the number the lease (``ZOO_ELASTIC_LEASE_MS``) trades against
    false-positive deaths."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.enabled = reg.enabled
        self.generation = reg.gauge(
            "zoo_elastic_generation",
            "membership generation (increments on any join/leave)")
        self.world_size = reg.gauge(
            "zoo_elastic_world_size",
            "live training-worker count of the current generation")
        self.rejoins = reg.counter(
            "zoo_elastic_rejoins_total",
            "generation changes orchestrated by the supervisor, "
            "by reason", labelnames=("reason",))
        self.worker_deaths = reg.counter(
            "zoo_elastic_worker_deaths_total",
            "workers found dead (expired lease or dead process) by the "
            "supervisor's scan")
        self.respawns = reg.counter(
            "zoo_elastic_respawns_total",
            "worker processes respawned by the supervisor")
        self.steps_lost = reg.counter(
            "zoo_elastic_steps_lost_total",
            "training steps replayed from the latest snapshot after an "
            "uncheckpointed fault")
        self.rebalances = reg.counter(
            "zoo_elastic_rebalances_total",
            "straggler-driven micro-batch share rebalances")
        self.rejoin_seconds = reg.histogram(
            "zoo_elastic_rejoin_seconds",
            "wall time from generation change to the new cohort's "
            "first step")


class ScrapeMetrics:
    """Federation-scraper telemetry (``zoo_scrape_*``,
    metrics/scrape.py).

    ``staleness_seconds`` is the load-bearing gauge: seconds since the
    last successful pull from each target.  A dead host's counters stop
    moving but its LAST values persist in the aggregator (flagged
    ``stale`` — merge.py), so staleness is the only signal that
    distinguishes "quiet host" from "vanished host"; the default
    heartbeat SLO watches exactly this family."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.enabled = reg.enabled
        self.targets = reg.gauge(
            "zoo_scrape_targets",
            "targets currently in the scrape set (static + discovered)")
        self.fetches = reg.counter(
            "zoo_scrape_fetches_total",
            "successful telemetry pulls, by target",
            labelnames=("target",))
        self.errors = reg.counter(
            "zoo_scrape_errors_total",
            "failed telemetry pulls (connect/timeout/decode), by target",
            labelnames=("target",))
        self.staleness = reg.gauge(
            "zoo_scrape_staleness_seconds",
            "seconds since the last successful pull, by target",
            labelnames=("target",))
        self.fetch_seconds = reg.histogram(
            "zoo_scrape_fetch_seconds",
            "wall time of one target pull (GET + decode + ingest)")


class SloMetrics:
    """Burn-rate engine telemetry (``zoo_slo_*``, metrics/slo.py).

    ``burn_rate`` is windowed (label ``window`` = short/long): 1.0
    means the error budget burns exactly at the sustainable rate; an
    alert needs BOTH windows above the spec's threshold, so a brief
    spike (short high, long low) and old news (long high, short low)
    both stay quiet.  ``alert_active`` is the current verdict per SLO;
    ``alerts_total`` counts firing transitions."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.enabled = reg.enabled
        self.burn_rate = reg.gauge(
            "zoo_slo_burn_rate",
            "error-budget burn rate per SLO and window "
            "(1.0 = burning exactly at budget)",
            labelnames=("slo", "window"))
        self.alert_active = reg.gauge(
            "zoo_slo_alert_active",
            "1 while the multi-window burn alert fires, by SLO",
            labelnames=("slo",))
        self.alerts = reg.counter(
            "zoo_slo_alerts_total",
            "alert firing transitions (quiet -> firing), by SLO",
            labelnames=("slo",))
        self.evaluations = reg.counter(
            "zoo_slo_evaluations_total",
            "engine evaluation ticks across all specs")


def record_device_memory(registry: MetricsRegistry | None = None) -> int:
    """Snapshot per-device memory stats into gauges.

    The reference's three gauges, from each CUDA device this process has
    already put memory on:

    - ``zoo_device_bytes_in_use`` <- ``memory_stats()``'s
      ``allocated_bytes.all.current``;
    - ``zoo_device_peak_bytes_in_use`` <- ``allocated_bytes.all.peak``;
    - ``zoo_device_bytes_limit`` <- ``torch.cuda.mem_get_info()[1]`` (the
      device's total memory).

    A visible device that the caching allocator has never reserved memory
    on is skipped: ``mem_get_info`` would create a CUDA context there
    (hundreds of MB, and an error on a GPU held exclusively by another
    process), and the port runs on one device.  ``memory_stats`` reads
    the allocator's counters and creates no context.

    Returns the number of devices that reported stats (0 on a host with
    no CUDA device, or before this process used one — then no gauges are
    touched)."""
    import torch

    reg = registry if registry is not None else get_registry()
    if not reg.enabled or not torch.cuda.is_available() \
            or not torch.cuda.is_initialized():
        return 0
    reported = 0
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats.get("reserved_bytes.all.peak", 0):
            continue  # never used here: no context to read it through
        values = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
        reported += 1
        for key, value in values.items():
            reg.gauge(
                f"zoo_device_{key}",
                "per-device HBM usage (jax memory_stats)",
                labelnames=("device",),
            ).labels(device=str(i)).set(value)
    return reported
