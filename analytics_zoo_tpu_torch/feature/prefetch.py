"""Parallel host data plane — multi-worker prefetch pipeline for FeatureSet.

The port's own copy of ``analytics_zoo_tpu/feature/prefetch.py`` (which
imports no JAX), with the same delivery order, telemetry and shutdown.
The reference hid data-loading latency behind Spark's distributed readers
(DiskFeatureSet's resident-slice design, FeatureSet.scala:332-409);
FeatureSet's generators are single-threaded, so without this module the
only latency hiding is the estimator's infeed thread.  tf.data (arxiv
2101.12127) showed that parallel extract/transform with a bounded
prefetch buffer and ORDERED delivery turns an input pipeline from the
bottleneck into a non-factor — this module is that shape for FeatureSet.
Its threads do host work only (no CUDA call), so they never touch a
captured step:

- :class:`PrefetchPipeline`: a producer thread walks the source iterator
  (shard loading, index selection, raw batch assembly) and hands the
  expensive per-batch work (host ``Preprocessing`` transforms, decode) to
  a thread pool; a bounded queue of IN-ORDER futures delivers batches to
  the consumer.  Futures are enqueued in source order, so worker
  completion order can never reorder the stream: same ``seed``/``epoch``
  ⇒ byte-identical batch stream vs. the serial path.
- Shard read-ahead: while a :class:`ShardedFeatureSet` slice is being
  consumed, the NEXT shard's ``loader(path)`` runs on the pool, so
  advancing the resident slice no longer stalls the feeder cold.
- Exception propagation: a worker/source error surfaces to the consumer
  at the stream position it occurred, then the pool and producer shut
  down cleanly (no orphaned threads, no wedged queue).
- Telemetry: ``zoo_data_prefetch_*`` (queue occupancy gauge,
  producer-stall / consumer-wait histograms, delivered-batch counter)
  plus an ``infeed``-style ``data_prefetch`` health heartbeat the
  producer beats per batch — a wedged input pipeline flips /healthz.

Thread workers scale work that releases the GIL (file IO, numpy decode,
cv2); pure-python transforms still win read-ahead — the producer runs off
the consumer thread — but not parallel speedup.

Determinism contract: the stream is byte-identical to the serial path
provided the transforms themselves are deterministic per record (seeded
per-(record, epoch) RNG, as the in-repo image ROI transforms are).  A
transform drawing from a process-global RNG would see a different draw
ORDER under concurrency — that is a property of the transform, not of
the pipeline's delivery order, which is always the serial order.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Iterable

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing
from analytics_zoo_tpu_torch.feature.dataset import (
    FeatureSet,
    ShardedFeatureSet,
    TransformedFeatureSet,
    _host_nbytes,
    _preprocess_batch,
)
from analytics_zoo_tpu_torch.metrics import DataPipelineMetrics, get_health

__all__ = ["PrefetchPipeline", "PrefetchFeatureSet", "FusedPreprocessing",
           "worth_prefetching"]


class FusedPreprocessing(Preprocessing):
    """N stacked transforms fused into ONE per-record callable (the
    map-fusion stage), with each intermediate materialized exactly the
    way the serial nested path hands it to the next stage.

    Serially, stage i's per-record outputs pass through ``np.stack``
    (batch re-assembly) before stage i+1 re-extracts its row: the next
    stage always receives an ``ndarray`` row (or a tuple of rows for
    multi-input batches), never stage i's raw Python return.  Plain
    function composition would leak raw returns (a list, a scalar)
    straight into stage i+1 — crashing or producing different bytes
    only under prefetch.  ``np.asarray`` per record reproduces the
    serial materialization for the deterministic same-dtype-per-record
    transforms the byte-identity contract covers, while skipping the
    N-1 full batch stack/unstack passes fusion exists to remove."""

    def __init__(self, stages):
        self.stages = list(stages)

    @staticmethod
    def _materialize(record):
        if isinstance(record, tuple):
            return tuple(np.asarray(a) for a in record)
        return np.asarray(record)

    def transform(self, record):
        last = len(self.stages) - 1
        for i, stage in enumerate(self.stages):
            record = stage(record)
            if i != last:
                record = self._materialize(record)
        return record


def worth_prefetching(fs) -> bool:
    """True when the prefetch plane has host work to hide: a
    ``Preprocessing`` chain (the pooled map stage), a sharded/disk base
    (shard loads + read-ahead), or a PMEM-spilled array set (page-cache
    reads).  A resident DRAM ``ArrayFeatureSet`` with no transforms has
    nothing to move off-thread — wrapping it only adds queue handoffs
    per batch, which is why the autotuner (feature/autotune.py) consults
    this before injecting the pipeline.  Unknown FeatureSet types return
    True (their ``batches()`` cost is unknowable; read-ahead is the safe
    default)."""
    from analytics_zoo_tpu_torch.feature.dataset import ArrayFeatureSet

    inner = fs
    while isinstance(inner, (TransformedFeatureSet, PrefetchFeatureSet)):
        if isinstance(inner, TransformedFeatureSet):
            return True
        inner = inner.base
    if isinstance(inner, ShardedFeatureSet):
        return True
    if isinstance(inner, ArrayFeatureSet):
        return getattr(inner, "_spool", None) is not None
    return True

# queue item kinds: a raw value, an in-flight future, end-of-stream
_VALUE, _FUTURE, _END = 0, 1, 2


class _ResizableQueue:
    """Bounded FIFO whose CAPACITY can change while producers and
    consumers are blocked on it (the autotune depth knob,
    feature/autotune.py).

    ``queue.Queue`` fixes ``maxsize`` at construction; resizing the
    prefetch window online must not drain or replace the queue — the
    items in it are the in-order stream, and delivery order is the
    byte-identity contract.  One deque + one Condition: :meth:`resize`
    only moves the capacity watermark and wakes waiters, so a grow
    unblocks a stalled producer immediately and a shrink simply stops
    admitting until the consumer drains below the new bound (queued
    items are never dropped).  API mirrors the ``queue.Queue`` subset
    the pipeline uses (timeout put/get raising Full/Empty).
    """

    def __init__(self, capacity: int):
        self._cond = threading.Condition()
        self._items: collections.deque = collections.deque()  # guarded-by: _cond
        self._capacity = int(capacity)  # guarded-by: _cond

    def put(self, item, timeout: float | None = None):
        with self._cond:
            if len(self._items) >= self._capacity:
                self._cond.wait(timeout)
                if len(self._items) >= self._capacity:
                    raise queue.Full
            self._items.append(item)
            self._cond.notify_all()

    def get(self, timeout: float | None = None):
        with self._cond:
            if not self._items:
                self._cond.wait(timeout)
                if not self._items:
                    raise queue.Empty
            item = self._items.popleft()
            self._cond.notify_all()
            return item

    def get_nowait(self):
        with self._cond:
            if not self._items:
                raise queue.Empty
            item = self._items.popleft()
            self._cond.notify_all()
            return item

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    @property
    def capacity(self) -> int:
        return self._capacity

    def resize(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._cond:
            self._capacity = int(capacity)
            self._cond.notify_all()


class _WorkerPool:
    """Thread pool whose worker count can grow AND shrink online (the
    autotune workers knob) — ``ThreadPoolExecutor`` only grows.

    ``submit`` returns a real :class:`concurrent.futures.Future`, so the
    pipeline's in-order future queue (and shard read-ahead, which rides
    the same pool) is unchanged.  Grow spawns threads immediately;
    shrink is lazy — surplus workers exit between tasks when they notice
    the lower target, so no in-flight transform is interrupted and
    delivery order is untouched.  ``shutdown`` stops dispatch; queued
    futures are left cancellable (the pipeline cancels them on close).
    """

    def __init__(self, workers: int, thread_name_prefix: str = "zoo-prefetch"):
        self._prefix = thread_name_prefix
        self._cond = threading.Condition()
        self._tasks: collections.deque = collections.deque()  # guarded-by: _cond
        self._target = int(workers)  # guarded-by: _cond
        self._live = 0  # guarded-by: _cond
        self._seq = 0  # guarded-by: _cond
        self._shutdown = False  # guarded-by: _cond
        self._spawn()

    def _spawn(self):
        new = []
        with self._cond:
            while not self._shutdown and self._live < self._target:
                self._live += 1
                self._seq += 1
                new.append(threading.Thread(
                    target=self._run, daemon=True,
                    name=f"{self._prefix}-{self._seq}"))
        for t in new:
            t.start()

    def _run(self):
        while True:
            with self._cond:
                if self._shutdown or self._live > self._target:
                    self._live -= 1
                    return
                if not self._tasks:
                    self._cond.wait(0.1)  # re-check shutdown/shrink
                    continue
                fut, fn, args = self._tasks.popleft()
            if not fut.set_running_or_notify_cancel():
                continue  # cancelled while queued (pipeline close)
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # delivered via future.result()
                fut.set_exception(e)

    def submit(self, fn, /, *args) -> Future:
        fut: Future = Future()
        with self._cond:
            if self._shutdown:
                # the ThreadPoolExecutor contract read-ahead relies on;
                # checked ATOMICALLY with the enqueue, so no task can
                # slip in behind shutdown's drain and pend forever
                raise RuntimeError("cannot submit after shutdown")
            self._tasks.append((fut, fn, args))
            self._cond.notify()
        return fut

    @property
    def max_workers(self) -> int:
        return self._target

    def resize(self, workers: int):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        with self._cond:
            self._target = int(workers)
            self._cond.notify_all()
        self._spawn()

    def shutdown(self, wait: bool = False):
        with self._cond:
            self._shutdown = True
            pending = list(self._tasks)
            self._tasks.clear()
            self._cond.notify_all()
        for fut, _, _ in pending:
            # never-started tasks resolve as CANCELLED instead of
            # pending forever: a consumer concurrently blocked in
            # future.result() gets CancelledError, not a hang (the
            # ThreadPoolExecutor path ran queued work; we cancel it)
            fut.cancel()
        if wait:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                with self._cond:
                    if self._live == 0:
                        return
                time.sleep(0.01)


# host bytes of one delivered batch (0 for non-dict payloads) — the
# SAME accounting ShardedFeatureSet uses for shard sizes, so the
# autotune RAM estimate never diverges between the two
_batch_nbytes = _host_nbytes


class PrefetchPipeline:
    """Thread-pool-backed, bounded-queue, ORDER-PRESERVING prefetcher.

    ``source`` is iterated by a dedicated producer thread; each item is
    either forwarded as-is (``map_fn=None`` — pure read-ahead) or
    submitted to a ``workers``-wide pool as ``map_fn(item)``.  The bounded
    queue (``depth``) holds futures in source order, so the consumer sees
    the exact serial stream while up to ``depth`` items are in flight and
    up to ``workers`` transforms run concurrently.

    Iterate the pipeline to consume; call :meth:`close` (or use it as a
    context manager) to shut down early.  A source or worker exception is
    re-raised to the consumer at its stream position.
    """

    def __init__(self, source: Iterable, map_fn: Callable | None = None,
                 workers: int = 2, depth: int = 4,
                 metrics: DataPipelineMetrics | None = None,
                 health_component: str = "data_prefetch",
                 stale_after: float = 60.0, start: bool = True):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.workers = int(workers)
        self.depth = int(depth)
        self._source = iter(source)
        self._map_fn = map_fn
        self._metrics = metrics if metrics is not None \
            else DataPipelineMetrics()
        self._metrics.workers.set(self.workers)
        self._metrics.depth_limit.set(self.depth)
        self._q = _ResizableQueue(self.depth)
        self._stop = threading.Event()
        self._pool = _WorkerPool(self.workers)
        self._hc = health_component
        self._stale_after = stale_after
        self._producer = threading.Thread(
            target=self._produce, daemon=True, name="zoo-prefetch-producer")
        if start:
            self._producer.start()

    def start(self) -> "PrefetchPipeline":
        """Start the producer (no-op if already running).  Construct
        with ``start=False`` when source-side state must attach to
        :attr:`pool` first — e.g. shard read-ahead: starting the
        producer before ``set_read_ahead(pipe.pool)`` would let the
        first loads race the attachment and fall back to synchronous
        loading on the producer thread."""
        if not self._producer.is_alive():
            try:
                self._producer.start()
            except RuntimeError:
                pass  # already started and finished: nothing to do
        return self

    # ------------------------------------------------------------------
    @property
    def pool(self) -> _WorkerPool:
        """The worker pool — ShardedFeatureSet read-ahead rides it too."""
        return self._pool

    @property
    def metrics(self) -> DataPipelineMetrics:
        """This pipeline's telemetry — the autotune controller reads its
        consumer-wait/producer-stall deltas to steer :meth:`resize`."""
        return self._metrics

    def resize(self, workers: int | None = None, depth: int | None = None):
        """Grow/shrink the worker pool and/or the bounded queue ONLINE —
        no drain, no re-creation, in-order delivery untouched (the queue
        of in-flight futures IS the stream; only watermarks move).

        The autotune controller's actuator (feature/autotune.py); also
        usable directly.  A depth shrink never drops queued batches — it
        stops admitting until the consumer drains below the new bound; a
        worker shrink lets surplus threads finish their current transform
        and exit between tasks.
        """
        if workers is not None:
            if workers < 1:
                raise ValueError(f"workers must be >= 1, got {workers}")
            self.workers = int(workers)
            self._pool.resize(self.workers)
            self._metrics.workers.set(self.workers)
        if depth is not None:
            if depth < 1:
                raise ValueError(f"depth must be >= 1, got {depth}")
            self.depth = int(depth)
            self._q.resize(self.depth)
            self._metrics.depth_limit.set(self.depth)

    # zoolint: hot-path
    def _put(self, item) -> bool:
        """Bounded put that respects close(); False when shut down.

        The time blocked on a full queue is the producer-stall histogram:
        a fat stall p99 means the consumer (device) is the bottleneck and
        the pipeline is keeping up — the healthy direction."""
        t0 = time.perf_counter()
        health = get_health()
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                self._metrics.producer_stall.observe(
                    time.perf_counter() - t0)
                self._metrics.queue_depth.set(self._q.qsize())
                return True
            except queue.Full:
                # still alive, just ahead of the consumer — keep beating
                health.heartbeat(self._hc)
        return False

    # zoolint: hot-path
    def _produce(self):
        health = get_health()
        health.register(self._hc, stale_after=self._stale_after)
        err: BaseException | None = None
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                health.heartbeat(self._hc)
                if self._map_fn is not None:
                    if not self._put((_FUTURE,
                                      self._pool.submit(self._map_fn, item))):
                        return
                elif not self._put((_VALUE, item)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            err = e
        finally:
            # unregister BEFORE the final put, on this thread: a pipeline
            # that finished early (everything buffered) must not read as
            # stale while the consumer drains, and no late beat can
            # resurrect the component (the _DeviceFeeder on_exit rule)
            health.unregister(self._hc)
            self._put((_END, err))

    # zoolint: hot-path
    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            while True:
                try:
                    kind, payload = self._q.get(timeout=0.1)
                    break
                except queue.Empty:
                    if self._stop.is_set() \
                            and not self._producer.is_alive():
                        return  # closed under us; producer already gone
            if kind == _END:
                self._metrics.consumer_wait.observe(
                    time.perf_counter() - t0)
                self._metrics.queue_depth.set(self._q.qsize())
                if payload is not None:
                    self._metrics.errors.inc()
                    raise payload
                return
            if kind == _FUTURE:
                try:
                    payload = payload.result()
                except BaseException:
                    self._metrics.errors.inc()
                    self.close()
                    raise
            # consumer_wait covers queue get AND the future's remaining
            # transform time: futures enqueue the moment the source
            # yields, so a transform-bound pipeline starves the consumer
            # inside result(), not get() — the autotune controller
            # steers on this histogram, so it must see BOTH.
            self._metrics.consumer_wait.observe(time.perf_counter() - t0)
            self._metrics.queue_depth.set(self._q.qsize())
            self._metrics.batches.inc()
            if self._metrics.enabled:
                # last-delivered batch bytes: the autotune RAM-budget
                # estimator's input (resident ≈ bytes x (depth+workers))
                self._metrics.batch_bytes.set(_batch_nbytes(payload))
            yield payload

    def close(self):
        """Stop the producer, cancel queued work, release the pool."""
        self._stop.set()
        # drain: unblocks a producer stuck on a full queue and drops
        # not-yet-started futures before the pool shutdown
        while True:
            try:
                kind, payload = self._q.get_nowait()
            except queue.Empty:
                break
            if kind == _FUTURE:
                payload.cancel()
        self._producer.join(timeout=5.0)
        self._pool.shutdown(wait=False)
        self._metrics.queue_depth.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PrefetchFeatureSet(FeatureSet):
    """``FeatureSet.prefetch(depth, workers)`` — same stream, off-thread.

    ``batches(...)`` yields the byte-identical stream of the wrapped
    FeatureSet, produced through a :class:`PrefetchPipeline`:

    - a :class:`TransformedFeatureSet` base is split at the transform
      boundary — raw batch assembly runs on the producer thread, the
      per-record ``Preprocessing`` runs batch-at-a-time on the pool
      (the parallel-map stage, where ``workers`` actually buys speedup);
    - a :class:`ShardedFeatureSet` base (directly or under transforms)
      additionally read-ahead-loads shard k+1 on the pool while shard k's
      batches are being consumed, so the resident-slice advance costs no
      feeder stall.

    Composes with the estimator's double-buffered device infeed
    untouched: the feeder simply consumes this iterator instead of the
    serial generator.
    """

    def __init__(self, base: FeatureSet, depth: int = 4, workers: int = 2,
                 metrics: DataPipelineMetrics | None = None,
                 controller=None):
        self.base = base
        self.depth = int(depth)
        self.workers = int(workers)
        self._metrics = metrics
        # AutotuneController (feature/autotune.py): when attached, each
        # epoch's pipeline starts at the controller's CURRENT tuned
        # (workers, depth) — convergence accumulates across the
        # per-batches() pipeline lifetimes — and the controller gets the
        # live pipeline handle to resize mid-epoch.
        self._controller = controller

    # -- delegation (the TransformedFeatureSet pattern) -----------------
    @property
    def device_transform(self):
        return self.base.device_transform

    @device_transform.setter
    def device_transform(self, fn):
        self.base.device_transform = fn

    @property
    def num_samples(self) -> int:
        return self.base.num_samples

    def transform(self, preprocessing) -> "PrefetchFeatureSet":
        """Keep the prefetch stage outermost so new transforms join the
        pooled map stage instead of running on the consumer thread."""
        return PrefetchFeatureSet(self.base.transform(preprocessing),
                                  self.depth, self.workers, self._metrics,
                                  controller=self._controller)

    def prefetch(self, depth: int = 4, workers: int = 2) \
            -> "PrefetchFeatureSet":
        return PrefetchFeatureSet(self.base, depth, workers, self._metrics,
                                  controller=self._controller)

    # ------------------------------------------------------------------
    def batches(self, *args, **kwargs):
        # Split at the transform boundary: everything below the
        # (possibly nested) TransformedFeatureSet wrappers is the source
        # walked serially by the producer; the collected preprocessing
        # chain is the pooled map stage.  Delivery order is source order,
        # so the emitted stream equals base.batches exactly.
        chain = []
        inner = self.base
        while isinstance(inner, TransformedFeatureSet):
            chain.append(inner.preprocessing)
            inner = inner.base
        chain.reverse()  # innermost transform applies first

        map_fn = None
        if chain:
            # Map-fusion: N stacked transforms fuse into ONE per-record
            # callable, so the pool pays one unstack/apply/restack pass
            # per batch instead of N (FusedPreprocessing materializes
            # each intermediate the way the serial np.stack boundary
            # does, keeping the stream byte-identical).
            fused = chain[0] if len(chain) == 1 \
                else FusedPreprocessing(chain)

            def map_fn(batch, _pre=fused):
                return _preprocess_batch(_pre, batch)

        ctrl = self._controller
        workers, depth, metrics = self.workers, self.depth, self._metrics
        if ctrl is not None:
            workers, depth = ctrl.pipeline_config(workers, depth)
            if metrics is None:
                metrics = ctrl.data_metrics
        sharded = inner if isinstance(inner, ShardedFeatureSet) else None
        # start=False: read-ahead must attach to the pool BEFORE the
        # producer walks the first shards, or the attachment races the
        # early loads (observed as synchronous producer-thread loads)
        pipe = PrefetchPipeline(
            inner.batches(*args, **kwargs), map_fn=map_fn,
            workers=workers, depth=depth, metrics=metrics,
            start=False)
        if sharded is not None:
            sharded.set_read_ahead(pipe.pool)
        if ctrl is not None:
            ctrl.attach_pipeline(pipe, sharded=sharded)
        pipe.start()
        try:
            yield from pipe
        finally:
            if ctrl is not None:
                ctrl.detach_pipeline(pipe)
            if sharded is not None:
                sharded.set_read_ahead(None)
            pipe.close()
