"""SLO-aware autoscaling policy for the serving fleet (counterpart of
``analytics_zoo_tpu/serving/scaler.py``).

:class:`SloScaler` is the PURE decision function the
:class:`~analytics_zoo_tpu_torch.serving.fleet.FleetController` ticks: it
consumes one rolling window of live fleet signals (the zootune
``Histogram.delta_since`` pattern — react to *recent* behavior, not a
lifetime blur) and answers "how many replicas should be serving".
Keeping it side-effect free makes the policy unit-testable with
fabricated windows — the controller owns threads, replicas and metrics.

The latency estimate is queueing-theory shaped rather than a bare
predict percentile: a saturated fleet shows its pain in the BACKLOG
long before predict itself slows down (predict time is per-batch and
flat under load), so the scaler estimates the tail *sojourn* time a
newly-arrived request faces as

    est_p99 = predict_p99 + unclaimed_backlog / service_rate

(Little's law for the wait, plus the service tail).  Scale-up follows
the HPA-style proportional rule ``ceil(replicas * est_p99 / slo)`` after
``up_windows`` consecutive violations — a 4x overload jumps straight
toward 4x capacity instead of creeping one replica per window — while
scale-down steps ONE replica at a time after ``down_windows``
consecutive slack windows (asymmetric on purpose: under-provisioning
burns the SLO, over-provisioning only burns idle replicas).  Broker
memory pressure is an immediate violation regardless of latency: by the
time ``memory_ratio`` reaches the server's trim threshold the fleet is
DROPPING records.

Federation tier: in a
multi-host fleet the controller's local registry only sees replicas it
spawned in-process; :class:`FederatedSignalSource` builds the SAME
``FleetSignals`` window from a :class:`~analytics_zoo_tpu_torch.metrics.
timeseries.TimeSeriesStore` that a :class:`~analytics_zoo_tpu_torch.metrics.
scrape.VarzScraper` fills from every replica's /telemetryz — so the
policy is unchanged while the signals become cluster-wide.  The pure
policy gains a second output: :meth:`SloScaler.decide_fleet` converts
the replica target into a host target via replicas-per-host packing.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["FleetSignals", "SloScaler", "FederatedSignalSource",
           "DEFAULT_SLO_P99_MS"]

# Default p99 SLO target (ms): generous enough that a single warm
# replica meets it on the bench synthetics, tight enough that a load
# step violates it within a couple of windows.
DEFAULT_SLO_P99_MS = 500.0


@dataclasses.dataclass
class FleetSignals:
    """One scaler window of fleet telemetry.

    ``predict_p99_s``/``window_count`` come from the registry's
    ``zoo_serving_predict_seconds`` rolling-window delta,
    ``service_rate`` from the ``zoo_serving_records_total`` delta over
    the window, ``queue_depth`` from ``Broker.unclaimed`` (claimed
    in-flight work is capacity in use, not demand), ``memory_ratio``
    from the broker."""

    predict_p99_s: float = 0.0
    window_count: int = 0
    service_rate: float = 0.0
    queue_depth: int = 0
    memory_ratio: float = 0.0


class SloScaler:
    """Sustained-violation / sustained-slack replica-count policy."""

    def __init__(self, slo_p99_ms: float = DEFAULT_SLO_P99_MS,
                 min_replicas: int = 1, max_replicas: int = 4,
                 up_windows: int = 2, down_windows: int = 6,
                 slack_ratio: float = 0.5, memory_high: float = 0.5,
                 prior_target: int | None = None):
        if slo_p99_ms <= 0:
            raise ValueError(f"slo_p99_ms must be > 0, got {slo_p99_ms}")
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        self.slo_p99_ms = float(slo_p99_ms)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_windows = max(1, int(up_windows))
        self.down_windows = max(1, int(down_windows))
        self.slack_ratio = float(slack_ratio)
        self.memory_high = float(memory_high)
        # oracle-seeded prior: where a FRESH fleet should
        # START.  None = the old reactive behavior (min_replicas, then
        # up_windows of violations before the first scale-up).  The
        # prior is consumed by the first decide() on an empty window —
        # after real telemetry arrives the reactive policy owns the
        # target again (the prior never caps or floors later decisions).
        if prior_target is not None:
            prior_target = min(self.max_replicas,
                               max(self.min_replicas, int(prior_target)))
        self.prior_target = prior_target
        self._prior_pending = prior_target is not None
        self._up_streak = 0
        self._down_streak = 0

    # ------------------------------------------------------------------
    def initial_target(self) -> int:
        """The replica count a fresh controller should SPAWN at: the
        oracle prior when one was seeded, ``min_replicas`` otherwise."""
        return self.prior_target if self.prior_target is not None \
            else self.min_replicas

    # ------------------------------------------------------------------
    def estimate_p99_s(self, sig: FleetSignals) -> float:
        """Estimated tail sojourn time for a request arriving NOW.

        ``inf`` when a backlog exists but nothing was served all window
        (a stalled/compiling fleet — the wait is unbounded as far as
        this window can tell); ``0.0`` on a fully idle window."""
        if sig.queue_depth > 0 and sig.service_rate <= 0:
            return math.inf
        wait = (sig.queue_depth / sig.service_rate
                if sig.service_rate > 0 else 0.0)
        return sig.predict_p99_s + wait

    # ------------------------------------------------------------------
    def decide(self, replicas: int, sig: FleetSignals) -> tuple[int, str]:
        """(target_replicas, reason) for this window; target ==
        ``replicas`` means hold (reason explains which streak is
        building, empty when fully steady)."""
        slo_s = self.slo_p99_ms / 1e3
        if self._prior_pending:
            # cold start: an empty window says NOTHING (no requests
            # have arrived), so without a prior the fleet would sit at
            # min_replicas for up_windows after the first load lands.
            # Jump straight to the oracle's target; real telemetry
            # takes over from the next window.
            self._prior_pending = False
            if sig.window_count == 0 and sig.queue_depth == 0 \
                    and replicas < self.prior_target:
                return self.prior_target, "oracle_prior"
        est = self.estimate_p99_s(sig)
        pressure = sig.memory_ratio >= self.memory_high
        violated = pressure or est > slo_s
        slack = not violated and est < self.slack_ratio * slo_s

        if violated:
            self._up_streak += 1
            self._down_streak = 0
            if self._up_streak >= self.up_windows \
                    and replicas < self.max_replicas:
                self._up_streak = 0
                if pressure:
                    # records are about to be trimmed: jump to max
                    return self.max_replicas, "broker_pressure"
                if math.isinf(est):
                    return min(replicas + 1, self.max_replicas), \
                        "stalled_backlog"
                # HPA-style proportional step toward the violating load
                target = min(self.max_replicas,
                             max(replicas + 1,
                                 math.ceil(replicas * est / slo_s)))
                return target, "slo_violation"
            return replicas, "violation_streak"
        if slack:
            self._down_streak += 1
            self._up_streak = 0
            if self._down_streak >= self.down_windows \
                    and replicas > self.min_replicas:
                self._down_streak = 0
                return replicas - 1, "sustained_slack"
            return replicas, "slack_streak"
        # in the comfort band: decay both streaks
        self._up_streak = 0
        self._down_streak = 0
        return replicas, ""

    # ------------------------------------------------------------------
    def decide_fleet(self, replicas: int, hosts: int, sig: FleetSignals,
                     replicas_per_host: int | None = None,
                     max_hosts: int | None = None,
                     ) -> tuple[int, int, str]:
        """``(target_replicas, target_hosts, reason)`` — the federated
        two-level decision.  Replica policy is :meth:`decide` verbatim;
        the host target is the packing consequence: enough hosts to
        hold the replica target at ``replicas_per_host`` (defaulting to
        the CURRENT observed packing ``ceil(replicas / hosts)``), never
        below 1, capped at ``max_hosts`` when given.  Still pure — the
        controller (or an external provisioner reading /varz) owns
        actually adding hosts."""
        target, reason = self.decide(replicas, sig)
        hosts = max(1, int(hosts))
        rph = (int(replicas_per_host) if replicas_per_host
               else max(1, math.ceil(max(1, replicas) / hosts)))
        target_hosts = max(1, math.ceil(target / rph))
        if max_hosts is not None:
            target_hosts = min(target_hosts, int(max_hosts))
        return target, target_hosts, reason


class FederatedSignalSource:
    """One scaler window assembled from SCRAPED per-host series.

    Reads the :class:`TimeSeriesStore` a :class:`VarzScraper` feeds
    (per-replica ``zoo_serving_predict_seconds`` /
    ``zoo_serving_records_total`` series, labeled by target) and the
    broker's queue state, producing the same :class:`FleetSignals` the
    local-registry path builds — the controller swaps sources, the
    policy never knows.  ``host_count()`` is the federation's second
    dimension: distinct FRESH targets currently contributing series
    (the scraper's staleness verdict keeps dead hosts out)."""

    def __init__(self, store, broker, stream: str,
                 scraper=None,
                 predict_family: str = "zoo_serving_predict_seconds",
                 records_family: str = "zoo_serving_records_total"):
        self.store = store
        self.broker = broker
        self.stream = stream
        self.scraper = scraper
        self.predict_family = predict_family
        self.records_family = records_family

    def gather(self, window_s: float) -> FleetSignals:
        """Fleet-wide window: p99 over the cross-host bucket merge,
        service rate as the sum of per-host counter rates, queue depth
        and memory ratio from the broker (shared state — already
        fleet-wide)."""
        summ = self.store.window_summary(self.predict_family, window_s)
        rate = self.store.rate(self.records_family, window_s)
        return FleetSignals(
            predict_p99_s=summ["p99"],
            window_count=summ["count"],
            service_rate=rate,
            queue_depth=self.broker.unclaimed(self.stream),
            memory_ratio=self.broker.memory_ratio(),
        )

    def host_count(self) -> int:
        """Live targets per the scraper's merged health verdict; falls
        back to counting distinct stored predict-series sources when no
        scraper is attached."""
        if self.scraper is not None:
            hz = self.scraper.healthz()
            return sum(1 for t in hz["targets"].values() if t["healthy"])
        return len(self.store.label_sets(self.predict_family))
