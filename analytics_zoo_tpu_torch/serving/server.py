"""Cluster Serving server (counterpart of
``analytics_zoo_tpu/serving/server.py``; reference
serving/ClusterServing.scala:44-230 and
serving/utils/ClusterServingHelper.scala).

The cycle: read up to ``batch_size`` records from the input stream, decode,
stack into one micro-batch, run the pooled/bucketed InferenceModel (one
captured CUDA graph per batch bucket on the card), write per-uri result
hashes back, apply backpressure by trimming the stream when the broker is
near memory capacity (ClusterServing.scala:126-134).

:meth:`ClusterServing.run` executes that cycle as a THREE-STAGE PIPELINE
(the default): a broker-reader thread polls + acks + decodes the next
micro-batch (decode fanned out on a small pool) while the current one is
in ``model.predict`` on the main loop, and a write-back thread drains a
bounded result queue — broker I/O and host decode overlap device
inference.  Result write-back is batched: ONE ``hset_many`` broker
round-trip per micro-batch instead of one ``hset`` per record.
``run(pipelined=False)`` keeps the strictly serial
read→decode→predict→write cycle (:meth:`step`); ``owner=`` runs the
fleet's claim mode (:meth:`_run_fleet`).

Captures inside ``run``: a bucket that no request has used yet is
captured by the first micro-batch that needs it, on the thread that calls
``predict`` (the thread that called ``run``: every mode predicts there).
That is safe without a warm-up, because
- every bucket of one ``InferenceModel`` captures and replays under its
  ``CaptureGroup``'s lock, which a request holds from the copy into its
  pinned staging buffer until its outputs are on the host, so no other
  request of that model copies in during a capture;
- the reader, decode-pool, writer and lease threads do no CUDA work
  (broker I/O and numpy decode only);
- captures run in ``thread_local`` error mode on their group's side
  stream, so another model's requests on other threads go on.
A warm-up (``InferenceModel.warmup``) before ``run`` only moves the
capture's seconds out of the first request's latency.

Every metric, span and flight record here is host-side work around
``predict``; a request's forward replays its capture, and nothing records
inside one.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..common.engine import serving_knob
from ..metrics import (
    FleetMetrics,
    ServingMetrics,
    StragglerDetector,
    get_flight_recorder,
    get_health,
    maybe_start_from_env,
    span,
)
from ..tensorboard import InferenceSummary
from .broker import connect_broker
from .client import INPUT_STREAM, RESULT_PREFIX, decode_ndarray, \
    encode_ndarray

logger = logging.getLogger("analytics_zoo_tpu_torch")

# Continuous-batching latency budget (ms): how long a PARTIAL shape
# bucket may wait for co-batchable arrivals before it is flushed to
# predict.  0 disables holding (every claim batch flushes immediately).
DEFAULT_BATCH_BUDGET_MS = 25.0
# Fleet work-claim lease (ms): a replica silent for this long forfeits
# its claimed-but-unserved records to the survivors.
DEFAULT_LEASE_MS = 10_000


def _env_number(name: str, default, cast, minimum):
    """Eager-validated numeric env knob (the ZooConfig resolve_int
    pattern): a bad value fails at server construction naming the env
    var."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        val = cast(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be a number >= {minimum}, got {raw!r}") from None
    if val < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {val}")
    return val


class ClusterServingHelper:
    """Config holder (reference ClusterServingHelper.scala yaml schema:
    model path, data shape, batch size, top_n, redis host/port)."""

    def __init__(self, config_path: str | None = None, **overrides):
        cfg = {}
        if config_path:
            import yaml
            with open(config_path) as f:
                cfg = yaml.safe_load(f) or {}
        model = cfg.get("model", {}) or {}
        params = cfg.get("params", {}) or {}
        data = cfg.get("data", {}) or {}
        self.model_path = overrides.get("model_path", model.get("path"))
        self.batch_size = int(overrides.get(
            "batch_size", params.get("batch_size", 4)))
        self.top_n = int(overrides.get("top_n", params.get("top_n", 1)))
        self.data_shape = overrides.get("data_shape",
                                        data.get("image_shape"))
        if isinstance(self.data_shape, str):
            self.data_shape = tuple(
                int(v) for v in self.data_shape.split(","))
        src = data.get("src", "localhost:6379")
        self.broker_spec = overrides.get("broker", src)
        self.log_dir = overrides.get("log_dir", cfg.get("log_dir", "."))
        # reference filter spec, e.g. "topN(5)" — wired into postprocess
        self.filter = overrides.get("filter", params.get("filter"))
        if isinstance(self.filter, str) and self.filter.startswith("topN("):
            self.top_n = int(self.filter[5:].rstrip(")"))
        # Fleet knobs (claim-mode serving): continuous-batching budget +
        # work-claim lease.  Precedence: explicit override > yaml params
        # > the value given to init_zoo_context (serving_batch_budget_ms
        # / fleet_lease_ms) > env (ZOO_SERVING_BATCH_BUDGET_MS /
        # ZOO_FLEET_LEASE_MS) > default — the ZooConfig env-tier
        # contract, validated eagerly.
        budget = overrides.get("batch_budget_ms",
                               params.get("batch_budget_ms"))
        if budget is None:
            budget = serving_knob("serving_batch_budget_ms")
        if budget is None:  # env parsed only when nothing overrides it
            budget = _env_number("ZOO_SERVING_BATCH_BUDGET_MS",
                                 DEFAULT_BATCH_BUDGET_MS, float, 0.0)
        self.batch_budget_ms = float(budget)
        if self.batch_budget_ms < 0:
            raise ValueError(
                f"batch_budget_ms must be >= 0, got {self.batch_budget_ms}")
        lease = overrides.get("lease_ms", params.get("lease_ms"))
        if lease is None:
            lease = serving_knob("fleet_lease_ms")
        if lease is None:
            lease = _env_number("ZOO_FLEET_LEASE_MS", DEFAULT_LEASE_MS,
                                int, 100)
        self.lease_ms = int(lease)
        if self.lease_ms < 100:
            raise ValueError(
                f"lease_ms must be >= 100 (shorter leases expire inside "
                f"one broker round-trip), got {self.lease_ms}")

    def load_inference_model(self):
        from ..pipeline.inference import InferenceModel
        m = InferenceModel(concurrent_num=1)
        m.load(self.model_path)
        return m


class _BucketBatcher:
    """Per-shape continuous batching for the fleet reader.

    Decoded records are admitted into the in-flight bucket for their
    SHAPE; a bucket flushes when it reaches ``batch_size`` (reason
    ``full``) or when its oldest record has waited ``budget_s`` seconds
    (reason ``budget``) — a lone request is served within the latency
    budget instead of waiting for co-batchable traffic that may never
    come, while a trickle of same-shape requests coalesces into one
    padded predict.  Flushed batches never exceed ``batch_size``, so
    they land in exactly the power-of-two pad buckets the fixed
    micro-batch path captures — continuous batching adds NO new CUDA
    graphs.  Single-thread use (the reader owns it); no locks."""

    def __init__(self, batch_size: int, budget_s: float):
        self.batch_size = max(1, int(batch_size))
        self.budget_s = max(0.0, float(budget_s))
        # shape -> list of (rid, uri, arr, t_admit)
        self._pending: dict = {}

    def add(self, rid: str, uri: str, arr, now: float) -> None:
        self._pending.setdefault(arr.shape, []).append(
            (rid, uri, arr, now))

    def __len__(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def next_deadline(self) -> float | None:
        """Monotonic time of the nearest bucket flush, or None when
        nothing is pending (the reader bounds its claim block on this
        so a partial bucket is flushed ON its budget, not up to one
        poll interval late)."""
        oldest = [recs[0][3] for recs in self._pending.values() if recs]
        return min(oldest) + self.budget_s if oldest else None

    def _chunk(self, shape, reason: str):
        recs = self._pending[shape][:self.batch_size]
        del self._pending[shape][:self.batch_size]
        if not self._pending[shape]:
            del self._pending[shape]
        ids = [r[0] for r in recs]
        uris = [r[1] for r in recs]
        arrs = [r[2] for r in recs]
        return ids, uris, arrs, reason

    def take_ready(self, now: float) -> list:
        """Flush full buckets, and partial buckets past their budget."""
        out = []
        for shape in list(self._pending):
            while len(self._pending.get(shape, ())) >= self.batch_size:
                out.append(self._chunk(shape, "full"))
            recs = self._pending.get(shape)
            if recs and now - recs[0][3] >= self.budget_s:
                out.append(self._chunk(shape, "budget"))
        return out

    def take_all(self) -> list:
        """Drain everything (shutdown path)."""
        out = []
        for shape in list(self._pending):
            while shape in self._pending:
                out.append(self._chunk(shape, "drain"))
        return out


class ClusterServing:
    """The serving main loop (reference ClusterServing.main)."""

    # backpressure thresholds (ClusterServing.scala:126-128)
    INPUT_THRESHOLD = 0.6 * 0.8
    CUT_RATIO = 0.5

    def __init__(self, helper: ClusterServingHelper | None = None,
                 model=None, broker=None, config_path: str | None = None,
                 owner: str | None = None, serve_log: str | None = None,
                 stream: str = INPUT_STREAM, trim: bool = True,
                 **overrides):
        self.helper = helper or ClusterServingHelper(config_path,
                                                     **overrides)
        self.db = connect_broker(broker if broker is not None
                                 else self.helper.broker_spec)
        # Multi-tenant routing: which stream this server
        # polls/claims.  The default is the single-tenant input stream;
        # the router runs one fleet per model stream.
        self.stream = str(stream)
        # trim=False: the stream is admission-guarded (serving/
        # admission.py sheds at the FRONT door), so the overload valve
        # must never drop records that were already accepted — the
        # exactly-once guarantee covers them.  Default True preserves
        # the unguarded backpressure behavior (scala parity).
        self.trim = bool(trim)
        self.model = model if model is not None \
            else self.helper.load_inference_model()
        # Fleet replica identity (serving/fleet.py): when set, run()
        # CLAIMS records under a lease instead of reading by cursor —
        # N owners against one broker never double-serve, and this
        # replica's death forfeits its in-flight claims to survivors
        # after helper.lease_ms.  Continuous batching rides the same
        # mode (helper.batch_budget_ms).
        self.owner = owner
        # Optional serve audit log: one "<owner> <uri>" line appended
        # AFTER each batch's results are durable and its claims
        # released — the exactly-once ledger the fleet tests (and any
        # delivery audit) read.
        self.serve_log = serve_log
        self.summary = InferenceSummary(
            self.helper.log_dir,
            time.strftime("%Y%m%d-%H%M%S") + "-ClusterServing")
        self._last_id = "0"
        self._stop = threading.Event()
        self._thread = None
        self.total_count = 0
        # Serving telemetry (metrics/): queue depth, batch size, latency
        # histograms per step() — no-op singletons when ZOO_METRICS=0.
        self.metrics = ServingMetrics()
        # Flight recorder + straggler detector: non-empty
        # cycles land in the bounded ring; a crashed step's final events
        # survive at /flightz and in the ZOO_FLIGHT_DIR dump.
        self._flight = get_flight_recorder()
        self._straggler = StragglerDetector()

    # ------------------------------------------------------------------

    def _postprocess(self, uri: str, out: np.ndarray) -> dict:
        """Top-N (class, prob) json for vectors, tensor payload otherwise
        (reference writes top-N class records back to redis).  The
        original uri rides along so dequeue() can key results on it even
        over transports whose key names are mangled (FileBroker)."""
        out = np.asarray(out)
        if out.ndim == 1 and self.helper.top_n:
            n = min(self.helper.top_n, out.shape[0])
            top = np.argsort(out)[::-1][:n]
            return {"uri": uri, "value": json.dumps(
                [[int(i), float(out[i])] for i in top])}
        return {"uri": uri, "tensor": encode_ndarray(out)}

    def _decode_one(self, rid: str, fields: dict):
        """One record -> ndarray, or None (logged) when undecodable or
        mis-shaped.  Pure per-record work — safe to fan out on a pool."""
        try:
            arr = decode_ndarray(fields["image"])
        except Exception:
            logger.warning("serving: undecodable record %s", rid)
            return None
        if self.helper.data_shape and \
                tuple(arr.shape) != tuple(self.helper.data_shape):
            logger.warning("serving: shape %s != expected %s (uri=%s)",
                           arr.shape, self.helper.data_shape,
                           fields.get("uri"))
            return None
        return arr

    def _decode_records(self, records, pool=None):
        """records -> (uris, arrs), bad records dropped.  With ``pool``
        the per-record base64+npy decode runs across pool threads (order
        preserved — Executor.map)."""
        if pool is not None:
            decoded = list(pool.map(
                lambda rf: self._decode_one(rf[0], rf[1]), records))
        else:
            decoded = [self._decode_one(rid, f) for rid, f in records]
        uris, arrs = [], []
        for (rid, fields), arr in zip(records, decoded):
            if arr is None:
                continue
            uris.append(fields.get("uri", rid))
            arrs.append(arr)
        return uris, arrs

    @staticmethod
    def _group_by_shape(uris, arrs) -> dict:
        # group by shape: with no configured data_shape, clients may send
        # mixed sizes; each group becomes one stacked micro-batch
        groups: dict = {}
        for uri, arr in zip(uris, arrs):
            groups.setdefault(arr.shape, ([], []))
            groups[arr.shape][0].append(uri)
            groups[arr.shape][1].append(arr)
        return groups

    # zoolint: hot-path
    def _predict_groups(self, groups) -> list:
        """Run predict per shape group; return the [(key, mapping)]
        write-back list for ONE batched broker round-trip."""
        writes = []
        for g_uris, g_arrs in groups.values():
            with self.metrics.predict_latency.time(), \
                    span("zoo.serving.predict",
                         args={"batch": len(g_uris)}):
                preds = self.model.predict(np.stack(g_arrs))
            if isinstance(preds, list):  # multi-output: report first head
                preds = preds[0]
            # zoolint: disable=host-sync -- predictions must land on host for write-back; the pipelined writer overlaps it
            for uri, out in zip(g_uris, np.asarray(preds)):
                writes.append((RESULT_PREFIX + uri,
                               self._postprocess(uri, out)))
        return writes

    def process_batch(self, records) -> int:
        if not records:
            return 0
        uris, arrs = self._decode_records(records)
        if not arrs:
            return 0
        t0 = time.perf_counter()
        writes = self._predict_groups(self._group_by_shape(uris, arrs))
        # one broker round-trip per micro-batch (hset_many pipelines or
        # falls back per-broker), not one hset per record
        self.db.hset_many(writes)
        dt = time.perf_counter() - t0
        self.total_count += len(uris)
        self.summary.add_scalar("Throughput", len(uris) / max(dt, 1e-9),
                                self.total_count)
        logger.info("serving: batch of %d in %.1f ms", len(uris), dt * 1e3)
        return len(uris)

    # zoolint: hot-path
    def step(self, block_ms: int = 100) -> int:
        """One poll + predict + write-back cycle; returns #records served."""
        ratio = self.db.memory_ratio()
        self.metrics.memory_ratio.set(ratio)
        if self.trim and ratio >= self.INPUT_THRESHOLD:
            # zoolint: disable=host-sync -- broker-side host integer, no device involved
            keep = int(self.db.xlen(self.stream) * self.CUT_RATIO)
            self.db.xtrim(self.stream, keep)
            self.metrics.trims.inc()
        records = self.db.xread(self.stream, self.helper.batch_size,
                                last_id=self._last_id, block_ms=block_ms)
        t0 = time.perf_counter()
        if records:
            self._last_id = records[-1][0]
        try:
            if records:
                # span only on non-empty cycles: an idle loop at
                # block_ms=100 would otherwise flood the bounded tracer
                # with ~10 zero-information events/sec
                with span("zoo.serving.step"):
                    n = self.process_batch(records)
            else:
                n = 0
        except BaseException as e:
            # a crashed step's last act: land in the flight ring, so
            # /flightz and the ZOO_FLIGHT_DIR dump show WHICH batch died
            self._flight.record_exception(e, where="serving.step")
            raise
        finally:
            if records:
                # ack consumed records so the stream cannot grow unbounded
                self.db.ack(self.stream, self._last_id)
        # service latency endpoint taken BEFORE any metrics-only broker
        # traffic below, so enabling metrics cannot inflate the very
        # latency being measured
        t_end = time.perf_counter()
        # true backlog: what remains AFTER this cycle's records were
        # acked — the xlen is an extra broker round-trip, so it only
        # runs when metrics are on and this cycle actually served
        # (an empty poll means the backlog was already drained)
        if records and self.metrics.enabled:
            self.metrics.queue_depth.set(self.db.xlen(self.stream))
        if records:
            # service latency for this cycle: decode + batch formation +
            # predict + write-back (poll wait excluded — the records
            # arrived by t0).  Queueing delay before the poll shows up in
            # queue_depth, not here.
            self._record_cycle(len(records), n, t_end - t0)
        return n

    def _record_cycle(self, n_read: int, n_served: int, dt: float):
        """Per-cycle telemetry shared by the serial step() and the
        pipelined loop: latency/batch-size/served metrics, the flight
        ring record (non-empty cycles only — an idle poll would flood
        the postmortem window), and straggler detection."""
        self.metrics.latency.observe(dt)
        self.metrics.batch_size.observe(n_read)
        self.metrics.records.inc(n_served)
        self._flight.record(
            "step", loop="serving", records=n_read, served=n_served,
            latency_s=round(dt, 6))
        if self._straggler.observe(dt):
            self.metrics.stragglers.inc()
            self._flight.record(
                "straggler", loop="serving", latency_s=round(dt, 6),
                rolling_p50_s=round(self._straggler.rolling_p50(), 6))

    def run(self, max_records: int | None = None,
            idle_timeout: float | None = None,
            pipelined: bool = True) -> int:
        """Blocking serve loop.  Stops after ``max_records`` served, after
        ``idle_timeout`` seconds without input, or on :meth:`stop`.

        ``pipelined=True`` (default) runs the three-stage pipeline —
        broker read + decode, predict, write-back on separate threads so
        the stages overlap; ``False`` keeps the strictly serial
        :meth:`step` cycle."""
        # a previous run() on this server closed its summary on exit (e.g.
        # a warm-up pass before start()): open a fresh event file
        if self.summary.closed:
            self.summary = InferenceSummary(
                self.helper.log_dir,
                time.strftime("%Y%m%d-%H%M%S") + "-ClusterServing")
        # Distributed telemetry plane: scrape endpoints opt in
        # via ZOO_METRICS_PORT; crash dumps arm via ZOO_FLIGHT_DIR; the
        # loop heartbeats /healthz every cycle (even idle polls — an
        # idle loop is alive; a WEDGED one goes 503 after 15s).
        maybe_start_from_env()
        self._flight.install()
        health = get_health()
        # 120s budget: one beat per cycle, and the first non-empty batch
        # pays the bucket's capture — seconds on big models;
        # /healthz must not 503 a process that is compiling, only one
        # that stopped cycling.
        health.register("serving_loop", stale_after=120.0)
        try:
            if self.owner is not None:
                # fleet replica: claim-based exactly-once loop with
                # continuous batching (always pipelined — the claim
                # protocol lives in the reader/writer stages)
                return self._run_fleet(max_records, idle_timeout, health)
            if pipelined:
                return self._run_pipelined(max_records, idle_timeout,
                                           health)
            return self._run_serial(max_records, idle_timeout, health)
        finally:
            health.unregister("serving_loop")  # stopped on purpose
            self.summary.close()

    def _run_serial(self, max_records, idle_timeout, health) -> int:
        served = 0
        last_active = time.monotonic()
        while not self._stop.is_set():
            try:
                n = self.step()
            except Exception:
                # a bad batch must not kill the serving loop/thread
                logger.exception("serving: batch failed; continuing")
                n = 0
            health.heartbeat("serving_loop")
            served += n
            if n:
                last_active = time.monotonic()
            if max_records is not None and served >= max_records:
                break
            if idle_timeout is not None and \
                    time.monotonic() - last_active > idle_timeout:
                break
        return served

    _PIPE_DEPTH = 2  # decoded micro-batches buffered ahead of predict

    # zoolint: hot-path
    def _run_pipelined(self, max_records, idle_timeout, health) -> int:
        """Three-stage pipeline: reader(poll+ack+decode) → predict →
        writer(batched hset_many).  Bounded queues between stages keep
        memory flat and deliver backpressure; a ``done`` event local to
        this run lets max_records/idle exits leave the server
        restartable (self._stop stays the external kill switch)."""
        in_q: queue.Queue = queue.Queue(maxsize=self._PIPE_DEPTH)
        out_q: queue.Queue = queue.Queue(maxsize=self._PIPE_DEPTH * 2)
        done = threading.Event()
        end = object()  # pipe sentinel
        decode_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="zoo-serving-decode")

        def stopped():
            return done.is_set() or self._stop.is_set()

        def bput(q, item) -> bool:
            while not stopped():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            health.register("serving_reader", stale_after=120.0)
            try:
                while not stopped():
                    try:
                        ratio = self.db.memory_ratio()
                        self.metrics.memory_ratio.set(ratio)
                        if self.trim and ratio >= self.INPUT_THRESHOLD:
                            # zoolint: disable=host-sync -- broker-side host integer, no device involved
                            keep = int(self.db.xlen(self.stream)
                                       * self.CUT_RATIO)
                            self.db.xtrim(self.stream, keep)
                            self.metrics.trims.inc()
                        records = self.db.xread(
                            self.stream, self.helper.batch_size,
                            last_id=self._last_id, block_ms=100)
                        health.heartbeat("serving_reader")
                        if not records:
                            continue
                        # advance the READ cursor only; the ack happens in
                        # the writer AFTER the batch's results are flushed,
                        # so a batch dropped by shutdown mid-pipeline stays
                        # in the stream (and the cursor rewind below makes
                        # the next run() re-read it)
                        self._last_id = records[-1][0]
                        uris, arrs = self._decode_records(
                            records, pool=decode_pool)
                        if self.metrics.enabled:
                            self.metrics.queue_depth.set(
                                self.db.xlen(self.stream))
                        if not bput(in_q, (len(records), self._last_id,
                                           uris, arrs)):
                            return
                    except Exception:
                        # a bad poll/decode must not kill the pipeline
                        logger.exception(
                            "serving: reader failed; continuing")
                        time.sleep(0.05)
            finally:
                health.unregister("serving_reader")
                bput(in_q, end)  # no-op when the main loop already left

        def writer():
            health.register("serving_writer", stale_after=120.0)
            try:
                while True:
                    try:
                        item = out_q.get(timeout=0.5)
                    except queue.Empty:
                        # an idle server is healthy — /healthz must not
                        # 503 a pipeline that simply has no traffic
                        health.heartbeat("serving_writer")
                        continue
                    if item is end:
                        return
                    writes, upto_id = item
                    try:
                        if writes:
                            self.db.hset_many(writes)
                        # results durable (or judged unservable): NOW the
                        # records may leave the stream
                        self.db.ack(self.stream, upto_id)
                    except Exception:
                        logger.exception(
                            "serving: write-back failed; continuing")
                    health.heartbeat("serving_writer")
            finally:
                health.unregister("serving_writer")

        rt = threading.Thread(target=reader, daemon=True,
                              name="zoo-serving-reader")
        wt = threading.Thread(target=writer, daemon=True,
                              name="zoo-serving-writer")
        rt.start()
        wt.start()
        served = 0
        # the last stream id whose batch was handed to the writer: the
        # exit cursor.  Anything the reader read beyond it was neither
        # predicted nor acked, so rewinding self._last_id here makes the
        # next run() serve it instead of skipping it.
        processed_id = self._last_id
        last_active = time.monotonic()
        try:
            while not self._stop.is_set():
                try:
                    item = in_q.get(timeout=0.1)
                except queue.Empty:
                    health.heartbeat("serving_loop")
                    if idle_timeout is not None and \
                            time.monotonic() - last_active > idle_timeout:
                        break
                    continue
                if item is end:
                    break
                n_read, batch_last_id, uris, arrs = item
                t0 = time.perf_counter()
                n = 0
                writes = []
                try:
                    if arrs:
                        with span("zoo.serving.step"):
                            writes = self._predict_groups(
                                self._group_by_shape(uris, arrs))
                        n = len(uris)
                except Exception as e:
                    self._flight.record_exception(e, where="serving.step")
                    logger.exception("serving: batch failed; continuing")
                    writes = []  # failed batch: ack it (serial parity)
                # always hand the batch to the writer — even an all-bad or
                # failed batch must be acked once its fate is sealed
                if not bput(out_q, (writes, batch_last_id)):
                    break
                processed_id = batch_last_id
                t_end = time.perf_counter()
                health.heartbeat("serving_loop")
                if n:
                    served += n
                    self.total_count += n
                    last_active = time.monotonic()
                    # latency here is the predict stage alone: decode and
                    # write-back run on their own threads, overlapped —
                    # that overlap is the point of the pipeline
                    self.summary.add_scalar(
                        "Throughput", n / max(t_end - t0, 1e-9),
                        self.total_count)
                    self._record_cycle(n_read, n, t_end - t0)
                if max_records is not None and served >= max_records:
                    break
        finally:
            done.set()
            rt.join(timeout=5.0)
            # the sentinel lands AFTER every enqueued write (FIFO), so
            # the writer flushes (and acks) all handed-off batches first
            try:
                out_q.put(end, timeout=5.0)
            except queue.Full:
                pass
            wt.join(timeout=5.0)
            decode_pool.shutdown(wait=False)
            self._last_id = processed_id
        return served

    # zoolint: hot-path
    def _run_fleet(self, max_records, idle_timeout, health) -> int:
        """Fleet-replica pipeline: claim(lease) + decode + continuous
        batching → predict → write-back + release(done).

        Differences from :meth:`_run_pipelined`, all in service of
        exactly-once across N replicas on one broker:

        - the reader CLAIMS records under ``helper.lease_ms`` instead of
          reading by cursor — other replicas cannot see claimed records,
          and a keepalive thread extends in-flight leases at lease/3 so
          a slow batch (first predict pays the bucket's capture)
          never forfeits mid-flight;
        - decoded records are admitted into per-shape buckets up to
          ``helper.batch_budget_ms`` (:class:`_BucketBatcher`) — a lone
          request is served within the budget, a trickle coalesces into
          one padded predict, a full bucket flushes immediately;
        - the writer RELEASES (``done=True``) each batch's claims only
          after its results are flushed — the claimed-record ack; clean
          shutdown releases leftovers with ``done=False`` so survivors
          re-claim them immediately instead of waiting out the lease.
        """
        in_q: queue.Queue = queue.Queue(maxsize=self._PIPE_DEPTH)
        out_q: queue.Queue = queue.Queue(maxsize=self._PIPE_DEPTH * 2)
        done = threading.Event()
        end = object()  # pipe sentinel
        decode_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="zoo-serving-decode")
        owner = self.owner
        lease_ms = self.helper.lease_ms
        batcher = _BucketBatcher(self.helper.batch_size,
                                 self.helper.batch_budget_ms / 1e3)
        fleet = FleetMetrics()
        inflight_lock = threading.Lock()
        # claimed ids not yet released (reader adds, writer removes,
        # keepalive extends, shutdown requeues)
        inflight: set = set()  # guarded-by: inflight_lock

        def stopped():
            return done.is_set() or self._stop.is_set()

        def bput(q, item) -> bool:
            while not stopped():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def keepalive():
            # extend at lease/3: two missed beats of margin before a
            # survivor may legally take the records over
            period = max(lease_ms / 3000.0, 0.05)
            while not done.wait(period):
                if self._stop.is_set():
                    return
                with inflight_lock:
                    ids = sorted(inflight)
                if not ids:
                    continue
                try:
                    self.db.extend(self.stream, owner, ids, lease_ms)
                except Exception:
                    logger.exception(
                        "serving: lease keepalive failed; continuing")

        def admit(records, now):
            """Hand one claim batch to the batcher.  On ANY failure the
            claimed-but-unadmitted records are dropped from ``inflight``
            (stopping the keepalive renewing their leases forever — the
            wedged-invisible failure mode) and requeued for immediate
            re-claim; if even the requeue fails, the lease simply
            expires to a survivor."""
            with inflight_lock:
                inflight.update(r[0] for r in records)
            admitted: set = set()
            try:
                takeovers = self.db.pop_takeovers(owner)
                if takeovers:
                    # a dead replica's records reclaimed:
                    # the fleet's fault-tolerance event
                    fleet.lease_takeovers.inc(takeovers)
                    self._flight.record(
                        "lease_takeover", owner=owner,
                        records=takeovers)
                decoded = list(decode_pool.map(
                    lambda rf: self._decode_one(rf[0], rf[1]),
                    records))
                bad = [rid for (rid, _), arr
                       in zip(records, decoded) if arr is None]
                if bad:
                    # undecodable/mis-shaped: judged unservable — ack
                    # so no replica loops on them (serial-mode parity)
                    self.db.release(self.stream, owner, bad, done=True)
                    with inflight_lock:
                        inflight.difference_update(bad)
                    admitted.update(bad)  # handled: don't requeue
                for (rid, fields), arr in zip(records, decoded):
                    if arr is not None:
                        batcher.add(rid, fields.get("uri", rid),
                                    arr, now)
                        admitted.add(rid)
            except Exception:
                leftover = [r[0] for r in records
                            if r[0] not in admitted]
                with inflight_lock:
                    inflight.difference_update(leftover)
                try:
                    self.db.release(self.stream, owner, leftover,
                                    done=False)
                except Exception:
                    pass  # broker down: leases expire to survivors
                raise

        def reader():
            health.register("serving_reader", stale_after=120.0)
            depth_refreshed = 0.0
            try:
                while not stopped():
                    try:
                        ratio = self.db.memory_ratio()
                        self.metrics.memory_ratio.set(ratio)
                        if self.trim and ratio >= self.INPUT_THRESHOLD:
                            # zoolint: disable=host-sync -- broker-side host integer, no device involved
                            keep = int(self.db.xlen(self.stream)
                                       * self.CUT_RATIO)
                            self.db.xtrim(self.stream, keep)
                            self.metrics.trims.inc()
                        # block until records OR the nearest partial
                        # bucket's budget, whichever is sooner
                        nd = batcher.next_deadline()
                        block = 100 if nd is None else max(
                            0, min(100, int((nd - time.monotonic()) * 1e3)))  # zoolint: disable=host-sync -- host clock math, no device value
                        records = self.db.claim(
                            self.stream, owner, self.helper.batch_size,
                            lease_ms, block_ms=block)
                        health.heartbeat("serving_reader")
                        now = time.monotonic()
                        if records:
                            admit(records, now)
                            if self.metrics.enabled \
                                    and now - depth_refreshed >= 0.5:
                                # rate-limited: unclaimed() walks the
                                # whole stream (spool listdir / full
                                # scan under the broker lock) — not a
                                # per-batch hot-path cost for a gauge
                                depth_refreshed = now
                                self.metrics.queue_depth.set(
                                    self.db.unclaimed(self.stream))
                        for bucket in batcher.take_ready(time.monotonic()):
                            fleet.batch_flushes.labels(
                                reason=bucket[3]).inc()
                            if not bput(in_q, bucket):
                                return
                    except Exception:
                        # a bad poll/decode must not kill the pipeline
                        logger.exception(
                            "serving: fleet reader failed; continuing")
                        time.sleep(0.05)
            finally:
                health.unregister("serving_reader")
                bput(in_q, end)  # no-op when the main loop already left

        def writer():
            health.register("serving_writer", stale_after=120.0)
            try:
                while True:
                    try:
                        item = out_q.get(timeout=0.5)
                    except queue.Empty:
                        health.heartbeat("serving_writer")
                        continue
                    if item is end:
                        return
                    writes, ids, uris = item
                    try:
                        if writes:
                            self.db.hset_many(writes)
                        # results durable (or the batch judged failed):
                        # NOW the claims end and the records leave the
                        # stream — the exactly-once commit point
                        self.db.release(self.stream, owner, ids,
                                        done=True)
                        if self.serve_log and writes:
                            with open(self.serve_log, "a") as f:
                                # one write() call: O_APPEND keeps
                                # concurrent replicas' lines whole
                                f.write("".join(
                                    f"{owner} {u}\n" for u in uris))
                    except Exception:
                        logger.exception(
                            "serving: write-back failed; continuing")
                    with inflight_lock:
                        inflight.difference_update(ids)
                    health.heartbeat("serving_writer")
            finally:
                health.unregister("serving_writer")

        rt = threading.Thread(target=reader, daemon=True,
                              name="zoo-serving-reader")
        wt = threading.Thread(target=writer, daemon=True,
                              name="zoo-serving-writer")
        kt = threading.Thread(target=keepalive, daemon=True,
                              name="zoo-serving-lease")
        rt.start()
        wt.start()
        kt.start()
        served = 0
        last_active = time.monotonic()
        try:
            while not self._stop.is_set():
                try:
                    item = in_q.get(timeout=0.1)
                except queue.Empty:
                    health.heartbeat("serving_loop")
                    if idle_timeout is not None and \
                            time.monotonic() - last_active > idle_timeout:
                        break
                    continue
                if item is end:
                    break
                ids, uris, arrs, _reason = item
                t0 = time.perf_counter()
                n = 0
                writes = []
                try:
                    with span("zoo.serving.step"):
                        writes = self._predict_groups(
                            self._group_by_shape(uris, arrs))
                    n = len(uris)
                except Exception as e:
                    self._flight.record_exception(e, where="serving.step")
                    logger.exception("serving: batch failed; continuing")
                    writes = []  # failed batch: release done (parity)
                if not bput(out_q, (writes, ids, uris)):
                    break
                t_end = time.perf_counter()
                health.heartbeat("serving_loop")
                if n:
                    served += n
                    self.total_count += n
                    last_active = time.monotonic()
                    self.summary.add_scalar(
                        "Throughput", n / max(t_end - t0, 1e-9),
                        self.total_count)
                    self._record_cycle(len(ids), n, t_end - t0)
                if max_records is not None and served >= max_records:
                    break
        finally:
            done.set()
            rt.join(timeout=5.0)
            # sentinel lands AFTER every enqueued write (FIFO): the
            # writer flushes + releases all handed-off batches first
            try:
                out_q.put(end, timeout=5.0)
            except queue.Full:
                pass
            wt.join(timeout=5.0)
            kt.join(timeout=5.0)
            decode_pool.shutdown(wait=False)
            # requeue every claim this replica still holds (batcher
            # remnants, in_q items, dropped batches): done=False makes
            # them immediately claimable by survivors — a clean exit
            # never makes the fleet wait out a lease
            with inflight_lock:
                leftover = sorted(inflight)
                inflight.clear()
            if leftover:
                try:
                    self.db.release(self.stream, owner, leftover,
                                    done=False)
                except Exception:
                    logger.exception(
                        "serving: shutdown requeue failed; leases will "
                        "expire instead")
        return served

    def start(self, **kwargs) -> "ClusterServing":
        """Run the loop on a daemon thread (embedded serving)."""
        self._thread = threading.Thread(target=self.run, kwargs=kwargs,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
