"""Closed-loop autotuning of the host data plane and fused dispatch.

The port's own copy of ``analytics_zoo_tpu/feature/autotune.py`` (which
imports no JAX).  ``ZOO_PREFETCH_WORKERS`` / ``ZOO_PREFETCH_DEPTH`` and
``ZOO_STEPS_PER_DISPATCH=K`` are static knobs that must be re-swept per
model, per host, per input pipeline; tf.data (arxiv 2101.12127) showed
that a controller driven by the pipeline's own telemetry matches or beats
hand tuning.  This module closes that loop:

- :class:`AutotuneController` runs on a daemon thread reading
  ROLLING-WINDOW deltas (``Histogram.delta_since``) of the
  ``zoo_data_prefetch_*`` telemetry and online-resizes the live
  :class:`~analytics_zoo_tpu_torch.feature.prefetch.PrefetchPipeline` —
  worker pool, bounded queue depth, and shard read-ahead — driving
  consumer-wait p50 → 0 under a host-RAM budget
  (``ZOO_AUTOTUNE_RAM_BUDGET``, estimated from observed batch/shard byte
  sizes x window size).  Resizes are in-place (no drain), so the
  delivered stream stays byte-identical through every decision.  The
  thread does host work only: no CUDA call, so it never meets a capture.
- The same controller picks ``steps_per_dispatch`` K at dispatch
  boundaries: the estimator feeds it measured per-dispatch wall time
  (:meth:`AutotuneController.observe_dispatch`) and it hill-climbs over
  ``{1, 2, 4, 8, 16}``, settling on the smallest K within a few percent
  of the best per-step time.  Safe to explore online: each inner step's
  randomness comes from its GLOBAL step index (``StepRandomness``), so
  the loss trajectory is bit-identical regardless of the K sequence.  On
  the card each new K's first dispatch runs eagerly and is captured into
  a CUDA graph; ``k_warm_skip`` (3) keeps that dispatch out of the
  samples.

Not ported yet: the config oracle's prior (the reference's ``oracle=``,
which starts the K search from a prediction; ROADMAP queue 1 item 19).
:meth:`AutotuneController.from_config` builds no oracle, so the K search
is the ladder, as the reference's under ``ZOO_ORACLE=0``; an explicit
``oracle=`` raises ``NotImplementedError``.

Every decision is recorded three ways so a bad tune is diagnosable
post-mortem: the ``zoo_autotune_*`` metric family (current knob gauges +
a decision counter labeled knob/reason), an ``autotune`` flight-recorder
event, and a bounded structured decision log served at ``/varz``.  Set
``ZOO_TUNE_LOG_DIR`` to additionally PERSIST the log as JSONL (one
``decision`` record per knob change + one ``settle`` record carrying
the full measured per-K cost curve; size-capped via
``ZOO_TUNE_LOG_MAX_BYTES`` with one rotated predecessor).

Opt-in: ``ZOO_AUTOTUNE=1`` (or ``Estimator.train(..., autotune=True)``).
Unset, nothing here is imported, no thread exists, and the hot paths are
exactly the static-knob code.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import weakref

from analytics_zoo_tpu_torch.metrics import (
    AutotuneMetrics,
    DataPipelineMetrics,
    MetricsRegistry,
    get_flight_recorder,
    get_registry,
)

__all__ = ["AutotuneController", "K_CANDIDATES", "DEFAULT_RAM_BUDGET",
           "varz_doc"]

# The fused-dispatch search space: beyond K=16 the per-dispatch overhead
# is amortized to noise while checkpoint/validation cadence coarsens
# linearly.
K_CANDIDATES = (1, 2, 4, 8, 16)

# Default host-RAM budget for the prefetch window (batches in the queue +
# in-flight transforms + read-ahead shards): 2 GiB — generous for batch
# streams, conservative next to a training host's total RAM.
DEFAULT_RAM_BUDGET = 2 << 30

# ---------------------------------------------------------------------------
# Live-controller registry: /varz (metrics/http.py) includes the decision
# logs of whatever controllers exist, WITHOUT importing this module into
# metrics-only processes — http.py only consults sys.modules.
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: "weakref.WeakSet[AutotuneController]" = (  # guarded-by: _active_lock
    weakref.WeakSet())

# ---------------------------------------------------------------------------
# Persistent decision log (ZOO_TUNE_LOG_DIR): the in-memory bounded log
# survives only until process exit — this JSONL file is the outcome
# history across restarts (the reference's oracle trains on it).
# ---------------------------------------------------------------------------

DEFAULT_TUNE_LOG_MAX_BYTES = 4 << 20

_tune_log_lock = threading.Lock()


def _append_tune_log(record: dict) -> None:
    """Append one JSONL record to ``ZOO_TUNE_LOG_DIR/tune-<pid>.jsonl``
    (no-op when the env is unset).  Size-capped: past
    ``ZOO_TUNE_LOG_MAX_BYTES`` the file rotates to ``.1`` (one
    predecessor kept) so an always-on training job cannot grow the log
    unboundedly.  Best-effort — a full disk must never take tuning
    down."""
    log_dir = os.environ.get("ZOO_TUNE_LOG_DIR")
    if not log_dir:
        return
    try:
        line = json.dumps(record) + "\n"
        cap = int(os.environ.get("ZOO_TUNE_LOG_MAX_BYTES",
                                 DEFAULT_TUNE_LOG_MAX_BYTES))
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"tune-{os.getpid()}.jsonl")
        with _tune_log_lock:
            try:
                if os.path.getsize(path) + len(line) > cap:
                    os.replace(path, path + ".1")
            except OSError:
                pass  # no file yet, or rotation raced a cleanup
            with open(path, "a") as f:
                f.write(line)
    except (OSError, ValueError, TypeError):
        return


def varz_doc() -> dict:
    """The ``autotune`` section of ``/varz``: every live controller's
    current knob state plus the merged, time-ordered decision log."""
    with _active_lock:
        ctrls = list(_active)
    docs = [c.to_doc() for c in ctrls]
    decisions = sorted((d for doc in docs for d in doc["decisions"]),
                       key=lambda d: d["ts"])
    return {"controllers": docs, "decisions": decisions}


class AutotuneController:
    """Telemetry-driven controller for the prefetch pipeline and fused
    dispatch.

    One controller serves one training/ingest loop.  Attach points:

    - ``PrefetchFeatureSet(..., controller=c)`` hands it each epoch's
      live pipeline (and the underlying :class:`ShardedFeatureSet`, when
      there is one) — the controller's thread then resizes workers /
      depth / read-ahead between telemetry windows, and re-seeds the
      next epoch's pipeline with the tuned values.
    - the estimator calls :meth:`observe_dispatch` once per captured
      dispatch and :meth:`current_k` at chunk boundaries — the K
      hill-climb runs inline on those calls (no extra thread work).

    The thread starts lazily on the first pipeline attach (or an
    explicit :meth:`start`); :meth:`stop` joins it.  All tuned state
    survives pipeline re-creation, so convergence accumulates across
    epochs.
    """

    def __init__(self, ram_budget: int | None = None,
                 interval: float = 0.25,
                 min_window: int = 8,
                 wait_threshold_s: float = 1e-3,
                 max_workers: int | None = None,
                 max_depth: int = 64,
                 max_read_ahead: int = 4,
                 start_k: int = 1,
                 k_candidates=K_CANDIDATES,
                 k_samples: int = 6,
                 k_warm_skip: int = 3,
                 k_margin: float = 0.05,
                 registry: MetricsRegistry | None = None,
                 log_capacity: int = 256,
                 oracle=None):
        if oracle is not None:
            raise NotImplementedError(
                "AutotuneController(oracle=...): the config oracle's K "
                "prior is not ported yet (ROADMAP queue 1 item 19); omit "
                "it and the K search walks the ladder, as the reference's "
                "does under ZOO_ORACLE=0")
        self.ram_budget = int(ram_budget) if ram_budget else \
            DEFAULT_RAM_BUDGET
        self.interval = float(interval)
        self.min_window = int(min_window)
        self.wait_threshold_s = float(wait_threshold_s)
        # Default worker cap: NOT the core count — prefetch workers
        # scale GIL-releasing IO/decode (PR 3 measured 3.3x with 4
        # workers on a 1-core host), so cores only floor the cap.
        self.max_workers = int(max_workers) if max_workers else \
            min(8, 4 * (os.cpu_count() or 1))
        self.max_depth = int(max_depth)
        self.max_read_ahead = int(max_read_ahead)
        self.k_samples = int(k_samples)
        self.k_warm_skip = int(k_warm_skip)
        self.k_margin = float(k_margin)
        cands = sorted(set(int(k) for k in k_candidates) | {int(start_k)})
        self.k_candidates = tuple(cands)

        # zoo_autotune_* family lives in the PROCESS registry (NULL
        # children when ZOO_METRICS=0 — decisions still log internally);
        # the PIPELINE telemetry the policy reads must exist even with
        # metrics globally off, so fall back to a private registry then.
        self.metrics = AutotuneMetrics(registry=registry)
        reg = registry if registry is not None else get_registry()
        if not reg.enabled:
            reg = MetricsRegistry(enabled=True)
        self.data_metrics = DataPipelineMetrics(registry=reg)

        self._lock = threading.Lock()
        # tuned pipeline knobs; None until the first pipeline_config
        # seeds them from the starting configuration
        self.workers: int | None = None  # guarded-by: _lock
        self.depth: int | None = None  # guarded-by: _lock
        self.read_ahead = 1  # guarded-by: _lock
        # live handles (one epoch's pipeline; cleared on detach)
        self._pipe = None  # guarded-by: _lock
        self._sharded = None  # guarded-by: _lock
        # rolling-window baseline (Histogram.snapshot_state tuple)
        self._wait_base = None  # guarded-by: _lock
        # K hill-climb state
        self._k = int(start_k)  # guarded-by: _lock
        self._k_settled = False  # guarded-by: _lock
        # the train step's compile label, written to the settle record
        self._feature_label: str | None = None  # guarded-by: _lock
        self._k_skip: dict[int, int] = {}  # guarded-by: _lock
        self._k_times: dict[int, list] = {}  # guarded-by: _lock
        self._k_cost: dict[int, float] = {}  # guarded-by: _lock
        self.dispatches_observed = 0  # guarded-by: _lock
        # dispatches observed AT the tuner's current K — in-flight
        # chunks queued before a switch keep their old size (see
        # _chunk_batches_dynamic) and are pipeline latency, not tuning
        # observations; k_settle_dispatch counts search cost only
        self.tuning_dispatches = 0  # guarded-by: _lock
        self.k_settle_dispatch: int | None = None  # guarded-by: _lock
        self._decisions: collections.deque = (  # guarded-by: _lock
            collections.deque(maxlen=int(log_capacity)))
        self._thread: threading.Thread | None = None  # guarded-by: _lock
        self._stop = threading.Event()

        self.metrics.ram_budget.set(self.ram_budget)
        self.metrics.k.set(self._k)
        self.metrics.read_ahead.set(self.read_ahead)
        with _active_lock:
            _active.add(self)

    # ------------------------------------------------------------------
    # construction from the env tier
    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg, oracle=None) -> "AutotuneController":
        """Build from a :class:`~analytics_zoo_tpu_torch.common.engine.
        ZooConfig` (the ``ZOO_AUTOTUNE_*`` env tier).  No oracle is built
        (ROADMAP queue 1 item 19), so the K search is the ladder; an
        explicit ``oracle`` raises ``NotImplementedError``."""
        return cls(
            ram_budget=cfg.autotune_ram_budget,
            interval=cfg.autotune_interval,
            max_workers=cfg.autotune_max_workers,
            start_k=int(cfg.steps_per_dispatch or 1),
            oracle=oracle,
        )

    def set_feature_label(self, label: str) -> None:
        """Name the train step's compile label (the estimator calls this
        once the plan tag is known); the settle record carries it."""
        with self._lock:
            self._feature_label = str(label)

    # ------------------------------------------------------------------
    # pipeline attachment (PrefetchFeatureSet.batches)
    # ------------------------------------------------------------------
    def pipeline_config(self, workers: int, depth: int) -> tuple[int, int]:
        """The (workers, depth) the NEXT pipeline should start with:
        the caller's values on first use (seeding the tuned state),
        the tuned values afterwards."""
        with self._lock:
            if self.workers is None:
                self.workers = max(1, int(workers))
                self.depth = max(1, int(depth))
            return self.workers, self.depth

    def attach_pipeline(self, pipe, sharded=None) -> None:
        """Hand the controller one epoch's LIVE pipeline (and sharded
        source, for the read-ahead knob); re-baselines the telemetry
        window and lazily starts the control thread."""
        with self._lock:
            self._pipe = pipe
            self._sharded = sharded
            self._wait_base = None
            ahead = self.read_ahead
        if sharded is not None and ahead > 1:
            sharded.set_read_ahead_count(ahead)
        self.start()

    def detach_pipeline(self, pipe) -> None:
        with self._lock:
            if self._pipe is pipe:
                self._pipe = None
                self._sharded = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "AutotuneController":
        # the Event is internally synchronized; clear it outside the
        # controller lock (it is not controller state the lock guards)
        self._stop.clear()
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="zoo-autotune")
            t = self._thread
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception as e:
                # the controller must never take the training loop down;
                # a policy bug shows in the flight ring, not a crash
                get_flight_recorder().record_exception(e, where="autotune")

    # ------------------------------------------------------------------
    # the data-plane control loop (one tick per interval)
    # ------------------------------------------------------------------
    def _tick(self):
        with self._lock:
            pipe, sharded = self._pipe, self._sharded
            wait_base = self._wait_base
            read_ahead = self.read_ahead
        if pipe is None:
            return
        # seed tuned state from the live pipeline when attached directly
        # (PrefetchFeatureSet seeds via pipeline_config before attach)
        self.pipeline_config(pipe.workers, pipe.depth)
        m = pipe.metrics
        # the policy steers on consumer-wait alone; producer-stall stays
        # an operator diagnosis signal (observability.md) — no delta is
        # computed for it here, the control loop would only discard it
        wait = m.consumer_wait.delta_since(wait_base)
        new_wait_base = m.consumer_wait.snapshot_state()
        if wait_base is None:
            # first sight of this pipeline: establish the baseline only
            with self._lock:
                self._wait_base = new_wait_base
            return
        batch_bytes = int(m.batch_bytes.get())
        shard_bytes = int(sharded.last_shard_nbytes) if sharded is not None \
            else 0
        workers, depth = pipe.workers, pipe.depth
        estimate = batch_bytes * (depth + workers) + shard_bytes * read_ahead
        self.metrics.ram_estimate.set(estimate)

        if estimate > self.ram_budget and batch_bytes > 0:
            # hard constraint first: shed window until under budget
            target_depth = max(
                1, (self.ram_budget - shard_bytes * read_ahead)
                // batch_bytes - workers)
            target_depth = min(depth, target_depth)
            new_ahead = 1 if shard_bytes * read_ahead > self.ram_budget // 4 \
                else read_ahead
            self._consume_window(new_wait_base)
            self._apply(pipe, sharded, depth=target_depth,
                        read_ahead=new_ahead, reason="ram_budget")
            return

        if wait["count"] < self.min_window:
            return  # window too thin to act on; let it keep accumulating

        self._consume_window(new_wait_base)
        if wait["p50"] > self.wait_threshold_s:
            # the consumer is starving: the pipeline is the bottleneck.
            # Grow production (workers), the absorbing buffer (depth, up
            # to what the RAM budget allows), and — for sharded sources —
            # the shard read-ahead, then re-measure next window.
            new_workers = min(workers * 2, self.max_workers)
            # depth target: enough buffer to keep every worker busy and
            # absorb load bursts (~2x the pool), bounded by the RAM
            # budget — a starving consumer is a throughput problem more
            # depth alone cannot fix, so depth tracks workers instead of
            # running away to max_depth.
            depth_cap = min(self.max_depth, max(4, 2 * new_workers))
            if batch_bytes > 0:
                depth_cap = min(depth_cap, max(
                    1, (self.ram_budget - shard_bytes * read_ahead)
                    // batch_bytes - new_workers))
            new_depth = min(max(depth * 2, new_workers + 1), depth_cap)
            new_depth = max(new_depth, depth)  # never shrink on this path
            new_ahead = read_ahead
            if sharded is not None and read_ahead < self.max_read_ahead:
                if shard_bytes * (read_ahead + 1) + batch_bytes * \
                        (new_depth + new_workers) <= self.ram_budget:
                    new_ahead = read_ahead + 1
            self._apply(pipe, sharded, workers=new_workers,
                        depth=new_depth, read_ahead=new_ahead,
                        reason="consumer_wait")
        # else: consumer-wait p50 is ~0 — the goal state.  A fat
        # producer-stall p50 here means the DEVICE is the bottleneck and
        # the pipeline is keeping up; deliberately no shrink (idle pool
        # threads are near-free, and shrink/grow cycles would oscillate).

    def _consume_window(self, wait_base):
        with self._lock:
            self._wait_base = wait_base

    def _apply(self, pipe, sharded, workers: int | None = None,
               depth: int | None = None, read_ahead: int | None = None,
               reason: str = ""):
        """Actuate knob changes on the live pipeline + record each
        changed knob as a decision.  No controller lock is held while
        touching pipeline locks (lock-order hygiene)."""
        with self._lock:
            cur_w, cur_d, cur_a = self.workers, self.depth, self.read_ahead
        if workers is not None and cur_w is not None \
                and workers != cur_w:
            with self._lock:
                self.workers = int(workers)
            pipe.resize(workers=int(workers))
            self._record_decision("workers", cur_w, int(workers), reason)
            self.metrics.workers.set(int(workers))
        if depth is not None and cur_d is not None and depth != cur_d:
            with self._lock:
                self.depth = int(depth)
            pipe.resize(depth=int(depth))
            self._record_decision("depth", cur_d, int(depth), reason)
            self.metrics.depth.set(int(depth))
        if read_ahead is not None and read_ahead != cur_a:
            with self._lock:
                self.read_ahead = int(read_ahead)
            if sharded is not None:
                sharded.set_read_ahead_count(int(read_ahead))
            self._record_decision("read_ahead", cur_a, int(read_ahead),
                                  reason)
            self.metrics.read_ahead.set(int(read_ahead))

    def _record_decision(self, knob: str, old, new, reason: str):
        record = {"ts": time.time(), "knob": knob, "old": old,
                  "new": new, "reason": reason}
        with self._lock:
            self._decisions.append(dict(record))
        self.metrics.decisions.labels(knob=knob, reason=reason).inc()
        get_flight_recorder().record(
            "autotune", knob=knob, old=old, new=new, reason=reason)
        _append_tune_log({**record, "type": "decision",
                          "pid": os.getpid()})

    # ------------------------------------------------------------------
    # fused-dispatch K (driven inline by the estimator loop)
    # ------------------------------------------------------------------
    def current_k(self) -> int:
        """The K the NEXT chunk should be built with (read by the feeder
        thread at chunk boundaries; plain int read, no lock needed)."""
        return self._k

    def observe_dispatch(self, nk: int, step_s: float) -> None:
        """One measured dispatch: ``nk`` fused inner steps took
        ``step_s`` wall seconds (full loop iteration — the quantity K
        amortizes).  Drives the hill-climb over :attr:`k_candidates`:
        measure ``k_samples`` dispatches at the current K (after
        ``k_warm_skip`` warm dispatches paying the new program's
        compile, on the card its eager run and capture), then either probe
        the next candidate up — while the current K is still the best
        seen — or settle on the smallest K within ``k_margin`` of the best
        per-step time."""
        decision = None
        settled = None
        with self._lock:
            self.dispatches_observed += 1
            if self._k_settled or nk != self._k:
                return  # settled, or a stale chunk from before a switch
            self.tuning_dispatches += 1
            k = self._k
            if self._k_skip.get(k, 0) < self.k_warm_skip:
                self._k_skip[k] = self._k_skip.get(k, 0) + 1
                return
            times = self._k_times.setdefault(k, [])
            times.append(step_s / max(nk, 1))
            if len(times) < self.k_samples:
                return
            # mean over the window = window wall time / steps = inverse
            # THROUGHPUT, the quantity being tuned.  Neither min nor
            # median would do: dispatch is async, so the first
            # iterations after a K switch measure only host dispatch
            # cost while the device queue fills (runahead) — k_warm_skip
            # absorbs that fill (and the new K's capture), and the
            # remaining contiguous window averages to the true rate.
            self._k_cost[k] = sum(times) / len(times)
            decision = self._advance_k_locked(k)
            if self._k_settled:
                settled = {
                    "k": self._k,
                    "cost": self._k_cost.get(self._k),
                    "costs": {str(c): round(v, 9) for c, v
                              in sorted(self._k_cost.items())},
                    "label": self._feature_label,
                    "dispatch": self.k_settle_dispatch,
                }
        if decision is not None:
            old, new, reason = decision
            self._record_decision("k", old, new, reason)
            self.metrics.k.set(new)
        if settled is not None:
            self._publish_settle(settled)

    def _advance_k_locked(self, k: int):
        """Next hill-climb move; called with the lock held, returns the
        (old, new, reason) decision or None when K is unchanged."""
        costs = self._k_cost
        best_cost = min(costs.values())
        # smallest candidate within margin of the best: ties go to the
        # smaller K (finer checkpoint/validation cadence for free)
        best_k = min(c for c, m in costs.items()
                     if m <= best_cost * (1.0 + self.k_margin))
        i = self.k_candidates.index(k)
        if k == best_k and i + 1 < len(self.k_candidates):
            # zoolint: disable=guarded-by -- _locked suffix: observe_dispatch holds _lock across this call
            self._k = self.k_candidates[i + 1]
            return (k, self._k, "probe_up")
        # current K stopped improving (or the ladder is exhausted):
        # settle on the best measured
        # zoolint: disable=guarded-by -- _locked suffix: observe_dispatch holds _lock across this call
        self._k = best_k
        # zoolint: disable=guarded-by -- _locked suffix: observe_dispatch holds _lock across this call
        self._k_settled = True
        # zoolint: disable=guarded-by -- _locked suffix: observe_dispatch holds _lock across this call
        self.k_settle_dispatch = self.tuning_dispatches
        return (k, best_k, "settled") if best_k != k else None

    def _publish_settle(self, settled: dict) -> None:
        """Outside-lock settle record: the persistent tune log's label and
        full measured cost curve."""
        _append_tune_log({
            "ts": time.time(), "type": "settle", "pid": os.getpid(),
            "label": settled["label"], "k": settled["k"],
            "k_cost_per_step_s": settled["costs"],
            "dispatches": settled["dispatch"],
        })

    @property
    def k_settled(self) -> bool:
        return self._k_settled

    # ------------------------------------------------------------------
    # introspection (/varz, metrics_dump, benches)
    # ------------------------------------------------------------------
    def decision_log(self) -> list[dict]:
        with self._lock:
            return list(self._decisions)

    def current(self) -> dict:
        with self._lock:
            return {
                "workers": self.workers,
                "depth": self.depth,
                "read_ahead": self.read_ahead,
                "k": self._k,
                "k_settled": self._k_settled,
                "k_cost_per_step_s": {
                    str(kk): round(v, 6)
                    for kk, v in sorted(self._k_cost.items())},
                "ram_budget_bytes": self.ram_budget,
                "dispatches_observed": self.dispatches_observed,
                "tuning_dispatches": self.tuning_dispatches,
                "k_settle_dispatch": self.k_settle_dispatch,
            }

    def to_doc(self) -> dict:
        return {"current": self.current(), "decisions": self.decision_log()}
