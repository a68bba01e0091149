"""Estimator — the training loop (single-device subset).

Counterpart of ``analytics_zoo_tpu/pipeline/estimator/estimator.py``.  One
train step is the reference's ``one_step`` (estimator.py:936-1007) in eager
PyTorch: the forward with ``training=True`` and the step's generator, the
f32 loss mean, the backward (``torch.autograd.grad``), frozen-layer
masking, gradient clipping, the optimizer update and
``optax.apply_updates``.  The step's generator is
``step_generator(seed, global_step)`` on the model's device, the
counterpart of ``fold_in(PRNGKey(seed), step)``.

A conv net trains the same way: BatchNorm's moving statistics are the
model state, updated in place by each step (f32 under every compute
dtype), and ``SGD`` updates its momentum and count in place, with its
learning rate computed on the device from the count.

On the card the three training scopes take their kernels, as the JAX
package does under ``ZOO_USE_PALLAS=1``: attention (flash forward and
backward, where ``flash_eligible`` holds), ``loss.softmax_xent`` (2-D
logits with 1-D labels) and ``optimizer.adam`` (f32 leaves of at least 128
elements).  The train step runs under a plan
(``Estimator(plan=)``/``train(plan=)``, default ``dp``) through
``parallel.plan.compile_step``, as in the reference, so a plan's
``kernel_rules`` can opt a scope out with ``"xla"`` (its plain PyTorch
path).

Mixed precision, as in the reference (estimator.py:939-981): under a plan
with ``dtype_rules`` (``mixed_precision()``, ``"dp+bf16"``, or the
context's ``ZOO_DTYPE_POLICY`` overlaid on a plan without dtype rules) the
forward takes the per-role compute copy of the f32 masters
(``plan.compute_dtypes``, worked out once per fit) and the batch's
floating inputs in ``plan.compute_cast_dtype()``.  The casts are made
where autograd records them, so gradients arrive in f32; predictions go up
to f32 before the loss, the new state keeps the old state's dtypes, and
the masters and Adam's moments stay f32.  The eval step casts the same way
under the estimator's own plan (not a fit's ``plan=``), as the reference's
``_resolved_plan()`` gives it.  Every compute dtype a plan can name (bf16,
f16) has its kernel instances on the card, so an f16 plan
(``"dp+f16"``, ``ZOO_DTYPE_POLICY=".*=f16"``) trains there as bf16 does,
with no loss scaling (the reference has none).

``fit`` runs through the compile plane, as the reference's does
(estimator.py:1012-1051): each dispatch is :meth:`Estimator._dispatch`,
K train steps (``ZOO_STEPS_PER_DISPATCH``, the context's
``steps_per_dispatch``) that update the parameters, the optimizer state
and the model state in place (the reference donates them), through
``compile_step`` under the labels ``train_step{tag}`` and
``train_step_scan{k}{tag}`` (``tag`` is ``_<plan>`` for a plan other than
``dp``).  On the card the first dispatch of a signature runs eagerly (it
is step 1: it warms cuBLAS and loads the kernel libraries) and is
captured into a CUDA graph, which every later dispatch replays: one host
call a dispatch.  Inner step i takes global step step0 + i for its
randomness (``common.engine.StepRandomness``, the reference's in-graph
``fold_in``), so the masks are those of :meth:`train_step`, which stays
the uncaptured yardstick, and every K gives the K=1 trajectory bit for
bit.  An epoch's tail shorter than K runs the K=1 step.  Each dispatch's
losses go into a per-epoch device buffer, read once at the epoch
boundary; triggers fire once per dispatch, at its K-step boundary, as in
the reference.  ``fit`` works on its own copies of the parameters and
state (the model's tensors stay as they were until it hands the trained
ones over at the end); a later ``fit`` of the same estimator continues on
them in place.  :meth:`Estimator.warmup` captures the steps before the
first real batch.  The eval step (:meth:`Estimator.eval_step`, the
reference's per-batch ``eval_step``) goes through ``compile_step`` under
the ``eval_step`` label, captured on the card per batch shape, with the
parameters and state passed by reference (the buffers ``fit`` updates in
place); the loop over the set, the sums of the per-batch statistics and
``finalize`` stay outside it, as in the reference.  ``evaluate`` and
``fit``'s validation both run it.

Batches come from ``FeatureSet.batches`` with the reference's seeded
shuffle, so both packages see the same batches in the same order.  The
infeed is the reference's ``_DeviceFeeder`` (``ZOO_INFEED_DEPTH``, default
2): a host thread assembles up to ``depth`` dispatches' batches ahead
(shard loads included; a sharded set also reads one shard ahead on a pool
thread) and stages them, in pinned memory on the card; the fit's thread
copies each one up without waiting for the device.  The batch sequence,
and so the trajectory, is the same at every depth.  ``history`` holds one
record per epoch, as in the reference; ``loss_log`` holds every step's
``(iteration, loss)``.  With ``tensorboard=(log_dir, app_name)`` the epoch
boundary writes those losses as ``Loss`` scalars (each step once, on the
reference's iteration numbers), the epoch's ``Throughput``, and each
validation's results to the ``ValidationSummary``.

Fault tolerance, as the reference (estimator.py:335-588, 1286-1429):

- :class:`_Checkpointer` writes ``ckpt-<iteration>.pkl`` with the
  reference's payload (``params``, ``state``, ``opt_flat``: the optimizer
  state's leaves in optax's order, ``convert.opt_flat_leaves``, so either
  package resumes the other's file, ``global_step``, ``epoch``,
  ``next_batch``, ``seed``, the ``plan`` record and ``__ckpt_meta__``),
  each file and then the ``LATEST`` pointer through a temporary name and a
  rename, ``keep=3`` files.  Saves are asynchronous unless
  ``ZOO_ASYNC_CHECKPOINT=0``: the fit's thread only enqueues device copies
  of the live buffers on its stream (the captured steps update them in
  place on that stream, so the copies see exactly this step's values and
  the next replay waits behind them) and records an event; a writer thread
  waits on the event, copies to reusable pinned buffers on its own
  stream, pickles, fsyncs and renames.  At most one save is in flight.
- Resume: ``fit`` continues from ``LATEST`` at ``(epoch, next_batch)``
  with its ``seed`` and ``global_step``; the restored values are copied in
  place into the buffers the captured graphs read (no re-capture), and
  ``StepRandomness`` derives the resumed steps' keys from the global step,
  so the uninterrupted run's masks follow.  A checkpoint saved under
  another dtype policy is refused unless ``ZOO_DTYPE_RESUME=cast``.
- Retry: any exception but ``KeyboardInterrupt``, ``ValueError`` and
  ``TypeError`` is retried from ``LATEST`` up to
  ``ZOO_FAILURE_RETRY_TIMES`` times, then re-raised.
- ``ZOO_PROFILE_DIR``: one ``torch.profiler`` trace (``*.trace.json.gz``)
  of ``profile_steps`` warm steps, armed once per estimator.

The end trigger is checked at epoch boundaries only, as the reference's
epoch loop checks it (``while not end_trigger(...)``): a fit always ends
at the end of an epoch, so ``MaxIteration(n)`` with n inside an epoch
trains that epoch to its end, and a later ``fit`` of the same estimator
starts the next epoch.  A mid-epoch stop is a checkpoint's: a resume
continues from the snapshot's ``(epoch, next_batch)``.

Observability, as the reference's loop (estimator.py:1452-1470,
1616-1648, 1683-1684): ``StepMetrics`` on every dispatch (data wait,
dispatch and step seconds, steps and records), a
``zoo.train.step_dispatch`` span, one ``step`` flight record a dispatch,
``StragglerDetector`` on the per-step time, the ``train_loop`` heartbeat
(``stale_after=600``), ``record_device_memory`` and the epoch gauges at
each epoch boundary, ``maybe_start_from_env`` and the flight recorder's
crash dump.  All of it is host-side work around the replay of the
captured step, never inside a capture.  The checkpoint writer records
``ckpt`` flight events, the ``checkpoint_writer`` health component and
the ``zoo_ckpt_*`` families, and a flight dump first waits (bounded by
``ZOO_ELASTIC_GRACE_MS``) for the save in flight.

The host data plane, as the reference's (estimator.py:1171-1220,
1484-1521, 1620): a set's ``device_transform``
(``FeatureSet.transform_on_device``, a torch function of the batch dict)
runs first in every train and eval step, inside the capture, so a uint8
batch crosses to the card and is normalized there; the step cache keys on
the transform, so another transform is another capture.  With
``ZOO_PREFETCH_WORKERS`` (``prefetch_workers``) the train set goes through
``feature.prefetch.PrefetchFeatureSet``: shard loads, host transforms and
batch assembly on a pool, the stream byte-identical to the serial one
(a sharded set then reads ahead on that pool instead of the fit's own
one-thread pool).  ``train(autotune=True)`` (``ZOO_AUTOTUNE=1``) attaches a
``feature.autotune.AutotuneController`` for the fit: it resizes the pool
online and picks the steps a dispatch at chunk boundaries
(:func:`_chunks_dynamic`) from each dispatch's measured time; each inner
step still takes its global step's randomness, so the trajectory is K=1's
bit for bit.  The infeed thread beats the ``infeed`` health component.
:meth:`Estimator.measure_pure_step` times the K=1 captured step on a
device-resident batch.

Not ported yet: multi-host batch sharding and sharded plans (ROADMAP
queue 1 item 13), the config oracle's autotune prior (19), elastic
training (21).
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import socket
import threading
import time
import weakref
from functools import partial

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import (
    StepRandomness,
    cast_floats,
    get_zoo_context,
)
from analytics_zoo_tpu_torch.common.safe_pickle import safe_load
from analytics_zoo_tpu_torch.common.triggers import (
    EveryEpoch,
    MaxEpoch,
    TrainingState,
    ZooTrigger,
)
from analytics_zoo_tpu_torch.common.utils import (
    tree_leaves,
    tree_map,
    tree_map_many,
)
from analytics_zoo_tpu_torch.feature.dataset import (
    FeatureSet,
    ShardedFeatureSet,
)
from analytics_zoo_tpu_torch.metrics import (
    StepMetrics,
    StragglerDetector,
    get_flight_recorder,
    get_health,
    get_registry,
    maybe_start_from_env,
    record_device_memory,
    register_predump_hook,
    span,
)
from analytics_zoo_tpu_torch.ops.moe import aux_cost_leaves, collect_aux_cost
from analytics_zoo_tpu_torch.parallel.plan import (
    CaptureGroup,
    cast_to_compute,
    compile_step,
    kernels_off,
    resolve_plan,
    step_options,
    with_dtype_policy,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    _unflatten,
    apply_updates,
    apply_updates_,
)

logger = logging.getLogger("analytics_zoo_tpu_torch")


def _normalize_grad_clip(grad_clip):
    """``None | ("l2norm", max) | ("const", lo, hi)``; a bare scalar is a
    max-norm.  Validated here so a bad spec fails before training."""
    if grad_clip is None:
        return None
    if not isinstance(grad_clip, (tuple, list)):
        return ("l2norm", float(grad_clip))
    t = tuple(grad_clip)
    if len(t) == 2 and t[0] == "l2norm":
        return ("l2norm", float(t[1]))
    if len(t) == 3 and t[0] == "const":
        return ("const", float(t[1]), float(t[2]))
    raise ValueError(f"unknown grad clip {grad_clip!r}")


def _clip_grads(grads, grad_clip):
    """The reference's ``_clip_grads``: elementwise clamp, or scale every
    leaf by min(1, max_norm / (global L2 norm + 1e-12))."""
    grad_clip = _normalize_grad_clip(grad_clip)
    if grad_clip is None:
        return grads
    if grad_clip[0] == "const":
        _, lo, hi = grad_clip
        return tree_map(lambda g: torch.clamp(g, lo, hi), grads)
    _, max_norm = grad_clip
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _cast_params(params, casts):
    """``params`` as the forward takes them under ``casts`` (see
    ``Estimator.compute_casts``)."""
    param_dtypes, dtype = casts
    if param_dtypes is None:
        return cast_floats(params, dtype)
    return cast_to_compute(params, param_dtypes)


def _host_tensor(a, pin: bool):
    """A batch array as a host tensor (float64 becomes float32, as JAX's
    default, x64 off, makes it), pinned when ``pin``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    return t.pin_memory() if pin else t


def _tensor(a, device):
    """A batch array as a tensor on ``device``; to a CUDA device it goes
    from pinned memory, without waiting for the device."""
    device = torch.device(device)
    if device.type == "cuda":
        return _host_tensor(a, True).to(device, non_blocking=True)
    return _host_tensor(a, False).to(device)


def _stage(batch: dict, pin: bool) -> dict:
    """A host batch as host tensors (pinned when ``pin``); ``n_valid`` (the
    real rows of a padded batch) as a 0-d int32 tensor."""
    out = {}
    for k, v in batch.items():
        if k == "n_valid":
            out[k] = _host_tensor(np.asarray(v, np.int32), pin)
        elif isinstance(v, list):
            out[k] = [_host_tensor(a, pin) for a in v]
        else:
            out[k] = _host_tensor(v, pin)
    return out


def _upload(staged: dict, device) -> dict:
    """A staged batch on ``device`` (from pinned memory without waiting
    for the device)."""
    def up(t):
        return t.to(device, non_blocking=t.is_pinned())
    return {k: [up(a) for a in v] if isinstance(v, list) else up(v)
            for k, v in staged.items()}


def _chunks_dynamic(batches, k_fn):
    """Lists of K batches, K re-read from ``k_fn()`` at every chunk
    boundary, then the tail one batch a list: the batch sequence of K=1
    (the reference's ``_chunk_batches``, and with a moving K its
    ``_chunk_batches_dynamic``, the autotune plane's chunker).  A decision
    takes effect within one dispatch; a chunk in flight keeps the size it
    started with."""
    chunk = []
    k = max(1, int(k_fn()))
    for b in batches:
        if k <= 1:
            yield [b]
            k = max(1, int(k_fn()))
            continue
        chunk.append(b)
        if len(chunk) == k:
            yield chunk
            chunk = []
            k = max(1, int(k_fn()))
    for b in chunk:
        yield [b]


def _to_device(batch, device):
    """A host batch's arrays as tensors on ``device``; ``n_valid`` as a 0-d
    int32 tensor there, so that a captured eval step reads it from device
    memory."""
    device = torch.device(device)
    return _upload(_stage(batch, device.type == "cuda"), device)


class _DeviceFeeder:
    """The reference's double-buffered infeed (estimator.py:176-257): a
    host thread runs ``items`` (the batch stream, shard loads included)
    and ``stage`` on each item, up to ``depth`` items ahead of the fit's
    thread; an error on the thread is raised on the consumer's side, at
    the item where it happened.  ``heartbeat`` is called for each item and
    while blocked on a full queue (waiting for a capture is not being
    wedged); ``on_exit`` runs on the thread after its last beat (the
    estimator unregisters the ``infeed`` component there, so no late beat
    brings it back)."""

    _END = object()

    def __init__(self, items, stage, depth: int = 2, heartbeat=None,
                 on_exit=None):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._err: BaseException | None = None

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    if heartbeat is not None:
                        heartbeat()
            return False

        def run():
            try:
                for item in items:
                    if heartbeat is not None:
                        heartbeat()
                    if not put(stage(item)):
                        return
            except BaseException as e:  # raised on the consumer side
                self._err = e
            finally:
                if on_exit is not None:
                    try:
                        on_exit()
                    except Exception:
                        pass
            put(self._END)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="zoo-infeed")
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def stop(self):
        """Stop the thread and wait for it (a shard load in progress
        finishes first), so no later stream shares the set's state with
        it."""
        self._stop.set()
        self._thread.join()


def _async_checkpoint_enabled() -> bool:
    """``ZOO_ASYNC_CHECKPOINT``, default on; ``0`` writes inline."""
    raw = os.environ.get("ZOO_ASYNC_CHECKPOINT")
    if raw is None:
        return True
    s = str(raw).strip().lower()
    if s in ("", "1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(
        f"ZOO_ASYNC_CHECKPOINT must be a boolean "
        f"(1/0/true/false/yes/no/on/off), got {raw!r}")


def _map_tensors(tree, fn):
    """``tree`` (dicts, lists, tuples) with ``fn`` applied to each tensor
    leaf; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _tensors(tree) -> list:
    out = []
    _map_tensors(tree, out.append)
    return out


# A flight dump (SIGTERM, exit, crash) first waits, bounded by
# ZOO_ELASTIC_GRACE_MS, for every live checkpointer's save in flight, so
# the dump's last ``ckpt`` event says complete or error, never a bare
# start (the reference's shutdown ordering, estimator.py:298-331).
_live_ckpt_lock = threading.Lock()
_live_checkpointers: "weakref.WeakValueDictionary" = (  # guarded-by: _live_ckpt_lock
    weakref.WeakValueDictionary())


def _dump_flush_grace_s() -> float:
    """Lenient read of ZOO_ELASTIC_GRACE_MS: this runs inside a dying
    process and must never raise."""
    try:
        return max(0.0, int(os.environ.get("ZOO_ELASTIC_GRACE_MS",
                                           "5000")) / 1e3)
    except (TypeError, ValueError):
        return 5.0


def _flush_checkpointers_for_dump() -> None:
    with _live_ckpt_lock:
        cks = list(_live_checkpointers.values())
    for c in cks:
        c._flush_for_dump()


class _Checkpointer:
    """Snapshots of (params, optimizer state, model state, step, epoch,
    iterator position) in ``path`` (the reference's ``_Checkpointer``,
    estimator.py:335-588; BigDL's ``model.<iter>``/``optimMethod.<iter>``,
    Topology.scala:245-255).

    :meth:`save` copies the payload's tensors into reusable device buffers
    on the caller's current stream, records an event, and leaves the rest
    to a writer thread: it waits on the event, copies the snapshot into
    reusable pinned host buffers on a stream of its own, pickles, fsyncs
    and renames ``ckpt-<tag>.pkl.tmp`` into place, then writes ``LATEST``
    the same way and keeps the newest ``keep`` files.  So the caller never
    waits for the device, and no other thread reads the live buffers.  At
    most one save is in flight: the next save, :meth:`list` and
    :meth:`latest` wait for it, and its error is raised there.
    ``ZOO_ASYNC_CHECKPOINT=0`` runs the write on the caller's thread.
    ``stall_seconds``, ``write_seconds`` and ``bytes`` hold each save's
    stall of the caller, the writer's seconds and the file's size; the
    first two also go to the reference's ``zoo_ckpt_stall_seconds`` and
    ``zoo_ckpt_write_seconds`` histograms, completed saves to
    ``zoo_ckpt_writes_total``.  The writer runs as the
    ``checkpoint_writer`` health component and records ``ckpt`` flight
    events (start, complete, error)."""

    LATEST = "LATEST"
    FORMAT_VERSION = 1

    def __init__(self, path: str, over_write: bool = True, keep: int = 3):
        self.path = path
        self.over_write = over_write
        self.keep = keep
        self._pending: threading.Thread | None = None
        self._pending_err: BaseException | None = None
        self._snap = None    # reusable device buffers of the last payload
        self._host = None    # and their pinned host copies
        self._stream = None  # the writer's stream
        self.stall_seconds: list[float] = []
        self.write_seconds: list[float] = []
        self.bytes: list[int] = []
        reg = get_registry()
        self._stall_hist = reg.histogram(
            "zoo_ckpt_stall_seconds",
            "train-thread stall per checkpoint save: join of the "
            "previous in-flight write + device-side snapshot dispatch "
            "(the whole gather+serialize+rename when "
            "ZOO_ASYNC_CHECKPOINT=0)")
        self._write_hist = reg.histogram(
            "zoo_ckpt_write_seconds",
            "background D2H gather + serialization + atomic-rename time "
            "per snapshot")
        self._writes = reg.counter(
            "zoo_ckpt_writes_total", "completed checkpoint snapshots")
        with _live_ckpt_lock:
            _live_checkpointers[id(self)] = self
        register_predump_hook(_flush_checkpointers_for_dump)

    def _flush_for_dump(self):
        """Bounded join of the save in flight, so a flight dump holds its
        final ``ckpt`` event.  Never raises."""
        t = self._pending
        if t is not None and t.is_alive():
            t.join(timeout=_dump_flush_grace_s())

    def _wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            if self._pending_err is not None:
                err, self._pending_err = self._pending_err, None
                raise err

    def _device_buffers(self, leaves) -> list:
        """The reusable device buffers for ``leaves``' shapes (the pinned
        host buffers are made on the writer thread: pinning a snapshot's
        bytes takes a while)."""
        spec = [(t.shape, t.dtype, t.device) for t in leaves]
        if self._snap is None or [(t.shape, t.dtype, t.device)
                                  for t in self._snap] != spec:
            self._snap = [torch.empty_like(t) for t in leaves]
            self._host = None
        return self._snap

    def _host_buffers(self, snap) -> list:
        """The reusable pinned host copies of the CUDA leaves of ``snap``
        (None for a CPU leaf, which is its own host copy)."""
        if self._host is None:
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                          if t.device.type == "cuda" else None
                          for t in snap]
        return self._host

    def save(self, tag, payload: dict) -> str:
        """Snapshot ``payload`` (a dict of trees of tensors and python
        values) as ``ckpt-<tag>.pkl``."""
        t0 = time.perf_counter()
        fname = os.path.join(self.path, f"ckpt-{tag}.pkl")
        self._wait()
        os.makedirs(self.path, exist_ok=True)
        leaves = _tensors(payload)
        snap = self._device_buffers(leaves)
        with torch.no_grad():
            for s, t in zip(snap, leaves):
                s.copy_(t)
        cuda = [s.device for s in snap if s.device.type == "cuda"]
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cuda[0]))
            if self._stream is None:
                self._stream = torch.cuda.Stream(cuda[0])

        def write():
            health = get_health()
            flight = get_flight_recorder()
            t_w = time.perf_counter()
            try:
                health.heartbeat("checkpoint_writer")
                flight.record("ckpt", phase="start", tag=str(tag),
                              file=os.path.basename(fname))
                host = self._host_buffers(snap)
                if event is not None:
                    with torch.cuda.stream(self._stream):
                        self._stream.wait_event(event)
                        for h, s in zip(host, snap):
                            if h is not None:
                                h.copy_(s, non_blocking=True)
                    self._stream.synchronize()
                arrays = iter([(h if h is not None else s).numpy()
                               for h, s in zip(host, snap)])
                blob = _map_tensors(payload, lambda _: next(arrays))
                blob["__ckpt_meta__"] = {
                    "format_version": self.FORMAT_VERSION,
                    "saved_unix": time.time(),
                    "torch_version": str(torch.__version__),
                }
                tmp = fname + ".tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(blob, f)
                    # fsync before the rename: the name must not become
                    # durable before the data
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, fname)
                self._write_latest(os.path.basename(fname))
                self._gc()
                self.bytes.append(os.path.getsize(fname))
                dt = time.perf_counter() - t_w
                self.write_seconds.append(dt)
                self._writes.inc()
                self._write_hist.observe(dt)
                health.set_status("checkpoint_writer", True)
                flight.record("ckpt", phase="complete", tag=str(tag),
                              seconds=round(dt, 6))
            except BaseException as e:  # raised on the next save/_wait
                health.set_status("checkpoint_writer", False)
                flight.record("ckpt", phase="error", tag=str(tag),
                              error=repr(e))
                self._pending_err = e

        if _async_checkpoint_enabled():
            self._pending = threading.Thread(target=write, daemon=True,
                                             name="zoo-ckpt")
            self._pending.start()
            self.stall_seconds.append(time.perf_counter() - t0)
            self._stall_hist.observe(self.stall_seconds[-1])
        else:
            write()
            self.stall_seconds.append(time.perf_counter() - t0)
            self._stall_hist.observe(self.stall_seconds[-1])
            if self._pending_err is not None:
                err, self._pending_err = self._pending_err, None
                raise err
        return fname

    def _write_latest(self, basename: str):
        ptr = os.path.join(self.path, self.LATEST)
        tmp = ptr + ".tmp"
        with open(tmp, "w") as f:
            f.write(basename)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, ptr)
        # fsync the directory so both renames are durable
        try:
            dfd = os.open(self.path, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass

    def _gc(self):
        for f in self._list_files()[:-self.keep]:
            try:
                os.remove(f)
            except OSError:
                pass

    def _list_files(self) -> list[str]:
        if not os.path.isdir(self.path):
            return []
        files = [os.path.join(self.path, f) for f in os.listdir(self.path)
                 if f.startswith("ckpt-") and f.endswith(".pkl")]
        return sorted(files, key=os.path.getmtime)

    def list(self) -> list[str]:
        self._wait()  # a half-written snapshot must not be resumed from
        return self._list_files()

    def latest(self) -> dict | None:
        """The newest complete snapshot's payload (the reference's
        ``getLatestFile``, Topology.scala:1511-1528): the file ``LATEST``
        names, or the newest ``ckpt-*.pkl`` when that is newer or there is
        no pointer; None when there is none.  A newer ``format_version``
        is refused."""
        files = self.list()
        fname = None
        try:
            with open(os.path.join(self.path, self.LATEST)) as f:
                name = f.read().strip()
            cand = os.path.join(self.path, name)
            if name and os.path.exists(cand):
                fname = cand
        except OSError:
            fname = None
        if fname is None:
            if not files:
                return None
            fname = files[-1]
        elif files and files[-1] != fname:
            # a snapshot dropped in out of band can be newer than the
            # pointer's; any file under its final name is complete
            try:
                if os.path.getmtime(files[-1]) > os.path.getmtime(fname):
                    fname = files[-1]
            except OSError:
                pass
        with open(fname, "rb") as f:
            payload = safe_load(f)
        meta = payload.pop("__ckpt_meta__", {"format_version": 0})
        if meta.get("format_version", 0) > self.FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {fname} has format_version "
                f"{meta['format_version']} > supported "
                f"{self.FORMAT_VERSION}; upgrade the framework to resume "
                "from it")
        return payload


def _restore_(live, saved, where: str = "") -> None:
    """Copy ``saved`` (a tree of arrays from a checkpoint, dicts matched
    by key) into the tensors of ``live`` in place."""
    if isinstance(live, dict):
        if set(live) != set(saved):
            raise ValueError(
                f"checkpoint tree {where or '/'} has keys {sorted(saved)}, "
                f"the model {sorted(live)}")
        for k, v in live.items():
            _restore_(v, saved[k], f"{where}/{k}")
    elif isinstance(live, (list, tuple)):
        for i, (v, s) in enumerate(zip(live, saved, strict=True)):
            _restore_(v, s, f"{where}/{i}")
    else:
        arr = np.asarray(saved)
        if tuple(arr.shape) != tuple(live.shape):
            raise ValueError(f"checkpoint leaf {where} has shape "
                             f"{arr.shape}, the model {tuple(live.shape)}")
        live.copy_(torch.from_numpy(np.array(arr)).to(
            live.dtype))


class _Profile:
    """``ZOO_PROFILE_DIR``: one ``torch.profiler`` trace of
    ``profile_steps`` warm train steps, armed once per estimator from
    global step ``start + 3`` (the reference's ``jax.profiler`` capture,
    estimator.py:1445-1451), written as ``*.trace.json.gz``."""

    def __init__(self, est, device):
        cfg = est.ctx.config
        self.est, self.dir, self.steps = est, cfg.profile_dir, \
            int(cfg.profile_steps)
        self.at = (est.global_step + 3
                   if self.dir and not est._profiled else None)
        self.device = torch.device(device)
        self.prof = None

    def before(self, step: int) -> None:
        if self.at is not None and self.prof is None \
                and not self.est._profiled and step >= self.at:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
            self.at = step

    def after(self, step: int) -> None:
        if self.prof is not None and step >= self.at + self.steps:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"{socket.gethostname()}."
                            f"{os.getpid()}.{time.time_ns()}"
                            ".pt.trace.json.gz")
        self.prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
        self.prof = None
        self.est._profiled = True
        self.at = None


class Estimator:
    """Train and evaluate a KerasNet on its device.

    ``model_dir`` or ``checkpoint=(path, over_write)`` checkpoint the fit
    (default trigger ``EveryEpoch``) and resume it from ``LATEST``;
    ``tensorboard=(log_dir, app_name)`` writes its summaries (the
    reference's arguments, estimator.py:596-631)."""

    def __init__(self, model, optimizer=None, loss=None, metrics=None,
                 model_dir: str | None = None, grad_clip=None,
                 tensorboard=None, checkpoint=None, ctx=None, plan=None):
        self.model = model
        # a ShardingPlan or a plan name; None defers to ZOO_SHARDING_PLAN,
        # then "dp".  train(plan=) overrides it per fit.
        self.plan = plan
        self.optimizer = optimizer
        self.loss = loss
        self.metrics = list(metrics or [])
        self.grad_clip = _normalize_grad_clip(grad_clip)
        self.ctx = ctx or get_zoo_context()
        self._ckpt = None
        if checkpoint is not None:
            path, over_write = checkpoint
            self._ckpt = _Checkpointer(path, over_write)
        elif model_dir:
            self._ckpt = _Checkpointer(model_dir)
        self._writers = None
        if tensorboard is not None:
            from analytics_zoo_tpu_torch.tensorboard import (
                TrainSummary,
                ValidationSummary,
            )
            log_dir, app_name = tensorboard
            self._writers = (TrainSummary(log_dir, app_name),
                             ValidationSummary(log_dir, app_name))
        self.global_step = 0
        self.epoch = 1
        self.history: list[dict] = []
        self.loss_log: list[tuple[int, float]] = []
        self._opt_state = None  # persists across fit() calls
        self._profiled = False  # one profiler trace per estimator
        # the plan the last fit ran under: its name and dtype policy
        # ("" = none); the checkpoint's plan record adds the mesh and the
        # spec lists the reference writes
        self._plan_record: dict | None = None
        # the compile plane: train and eval steps per (K or None, plan),
        # the randomness of each K-step dispatch per (K, device), and the
        # buffers the last dispatch updated in place
        self._steps: dict = {}
        self._randomness: dict = {}
        self._buffers = None

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def compute_casts(self, plan, params):
        """What a step under ``plan`` casts to: (each leaf's compute dtype
        as a tree of ``params``' structure, or None to cast every floating
        leaf to the batch's dtype; the batch's floating dtype, None for
        f32).  A plan's dtype rules beat the context's ``compute_dtype``.
        It depends on the tree's structure alone, so it is worked out once
        per fit or evaluate."""
        dtype = self.ctx.compute_dtype
        if plan is None or not plan.dtype_rules:
            return None, dtype
        return (plan.compute_dtypes(params),
                plan.compute_cast_dtype() or dtype)

    def loss_and_grads(self, params, state, batch, rng, casts=None):
        """(loss, grads, new_state) of one training forward and backward;
        ``batch`` holds tensors on the model's device, ``rng`` is the step's
        generator, ``casts`` (from :meth:`compute_casts`; None: the
        context's ``compute_dtype``) the compute casts.  The loss is the
        task loss plus every ``moe_aux_cost`` of the new state.  Gradients
        have the masters' dtypes; integer leaves get zero gradients."""
        casts = casts or (None, self.ctx.compute_dtype)
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in tree_leaves(params)]
        p = _unflatten(params, leaves)
        with torch.enable_grad():
            # cast inside the recorded region: the casts' backward brings
            # the gradients up to f32 at the masters
            preds, new_state = self.model.forward(
                _cast_params(p, casts), cast_floats(batch["x"], casts[1]),
                state=state, training=True, rng=rng)
            preds = cast_floats(preds, torch.float32)
            loss = self.loss.mean(batch.get("y"), preds, batch.get("w"))
            # auxiliary losses reported through the state (MoE load
            # balancing: each stack's pre-weighted ``moe_aux_cost``) join
            # the training loss; the eval loss stays the task loss
            if aux_cost_leaves(new_state):
                loss = loss + collect_aux_cost(new_state)
        wrt = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for t in leaves:
            g = next(got) if t.requires_grad else None
            grads.append(torch.zeros_like(t) if g is None else g)
        new_state = tree_map(lambda s: s.detach(), new_state or {})
        if casts != (None, None):
            # the state keeps its dtypes from step to step
            new_state = tree_map_many(lambda new, old: new.to(old.dtype),
                                      new_state, state)
        return loss.detach(), _unflatten(params, grads), new_state

    def _mask_frozen(self, tree):
        frozen = getattr(self.model, "_frozen", ()) or ()
        if not frozen:
            return tree
        return {k: tree_map(torch.zeros_like, v) if k in frozen else v
                for k, v in tree.items()}

    def train_step(self, params, opt_state, state, rng, batch, casts=None):
        """One optimizer step under ``casts`` (:meth:`compute_casts`):
        (params, opt_state, state, loss)."""
        loss, grads, state = self.loss_and_grads(params, state, batch, rng,
                                                 casts)
        # frozen layers: grads AND updates masked to zero (the reference's
        # transfer-learning contract)
        grads = _clip_grads(self._mask_frozen(grads), self.grad_clip)
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(grads, opt_state,
                                                       params)
            params = apply_updates(params, self._mask_frozen(updates))
        return params, opt_state, state, loss

    def _step_(self, params, opt_state, state, rng, batch, casts):
        """:meth:`train_step` in place, as the reference's donated step:
        ``params``, ``opt_state`` and ``state`` take their new values where
        they are, with the same arithmetic; returns the loss."""
        loss, grads, new_state = self.loss_and_grads(params, state, batch,
                                                     rng, casts)
        grads = _clip_grads(self._mask_frozen(grads), self.grad_clip)
        with torch.no_grad():
            updates = self.optimizer.update_(grads, opt_state, params)
            apply_updates_(params, self._mask_frozen(updates))
            tree_map_many(lambda old, new: old.copy_(new), state, new_state)
        return loss

    def _dispatch(self, params, opt_state, state, keys, batches, casts,
                  device_transform=None):
        """``len(batches)`` train steps in place, inner step i under
        ``keys[i]`` (global step ``keys.step0 + i``), each batch first
        through ``device_transform`` when there is one: (params,
        opt_state, state, the (K,) f32 losses)."""
        if device_transform is not None:
            batches = [device_transform(b) for b in batches]
        losses = [self._step_(params, opt_state, state, keys[i], batch,
                              casts) for i, batch in enumerate(batches)]
        return params, opt_state, state, torch.stack(losses)

    # train steps kept per estimator: a caller that makes a new transform
    # for every fit would otherwise keep every capture alive
    _MAX_TRAIN_STEPS = 8

    def _train_step_for(self, k: int, plan, device_transform=None):
        """The planned K-step dispatch under ``plan`` with
        ``device_transform`` inside it, made once (the reference's cache,
        keyed on the transform, K and the plan)."""
        key = (k, plan.cache_key(), device_transform)
        step = self._steps.get(key)
        if step is None:
            train_keys = [kk for kk in self._steps if kk[0] is not None]
            while len(train_keys) >= self._MAX_TRAIN_STEPS:
                self._steps.pop(train_keys.pop(0))
            tag = "" if plan.name == "dp" else f"_{plan.name}"
            label = f"train_step{tag}" if k == 1 \
                else f"train_step_scan{k}{tag}"
            fn = self._dispatch if device_transform is None else partial(
                self._dispatch, device_transform=device_transform)
            step = self._steps[key] = compile_step(
                fn, plan, donate_argnums=(0, 1, 2),
                **step_options(self.model, label))
        return step

    def _eval_step_for(self, plan, device_transform=None):
        """The planned per-batch eval step under ``plan`` with
        ``device_transform`` inside it, made once: the parameters and
        state by reference, its captures in one pool."""
        key = (None, plan.cache_key(), device_transform)
        step = self._steps.get(key)
        if step is None:
            fn = self.eval_step if device_transform is None else partial(
                self.eval_step, device_transform=device_transform)
            step = self._steps[key] = compile_step(
                fn, plan, ref_argnums=(0, 1), group=CaptureGroup(),
                **step_options(self.model, "eval_step"))
        return step

    def _keys(self, k: int, device, seed: int, step0: int):
        """The root keys of a K-step dispatch from global step ``step0``."""
        key = (k, str(device))
        src = self._randomness.get(key)
        if src is None:
            src = self._randomness[key] = StepRandomness(device, k)
        return src.keys(seed & 0x7FFFFFFF, step0)

    def _steps_per_dispatch(self, value=None) -> int:
        k = self.ctx.steps_per_dispatch if value is None else int(value)
        if k < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        return k

    def _publish_plan_gauges(self, plan, params):
        """The planes' gauges for this fit's plan label, where the
        reference publishes them with its memory gauges: the precision
        plane's ``zoo_dtype_*`` when the plan has dtype rules, the kernel
        plane's ``zoo_kernel_*`` (selections and the kernels'
        launch/plain counters) when it has kernel rules."""
        from analytics_zoo_tpu_torch.parallel.plan import (
            record_dtype_gauges,
            record_kernel_gauges,
        )

        try:
            tag = "" if plan.name == "dp" else f"_{plan.name}"
            if plan.dtype_rules:
                record_dtype_gauges(f"train_step{tag}", plan, params)
            if plan.kernel_rules:
                record_kernel_gauges(f"train_step{tag}", plan)
        except Exception as e:  # telemetry must never fail a fit
            logger.debug("zoo plan gauges skipped: %s", e)

    def _own(self, params, opt_state, state):
        """The buffers a fit updates in place: those of this estimator's
        last dispatch when ``params`` are them, else copies (the moments
        laid out where the fused Adam kernel writes them)."""
        if self._buffers is not None and self._buffers[0] is params:
            return self._buffers
        # the eval captures read the buffers they were made on: drop them
        self._steps = {k: v for k, v in self._steps.items()
                       if k[0] is not None}
        return (tree_map(torch.clone, params),
                self.optimizer.in_layout(tree_map(torch.clone, opt_state)),
                tree_map(torch.clone, state))

    # ------------------------------------------------------------------
    # train / evaluate
    # ------------------------------------------------------------------
    def _resolve_plan(self, plan=None):
        """The effective plan: ``plan`` over the estimator's, then the
        config's ``ZOO_SHARDING_PLAN``, then ``dp``; an explicit
        ``ZOO_USE_PALLAS=0`` and the context's dtype policy
        (``ZOO_DTYPE_POLICY``) overlaid on a plan that has no rules of
        that kind (explicit beats environment)."""
        config = self.ctx.config
        plan = resolve_plan(plan if plan is not None else self.plan, config)
        if config.use_pallas is False:
            plan = kernels_off(plan)
        policy = self.ctx.dtype_policy
        if not policy or plan.dtype_rules:
            return plan
        if policy.strip().lower() == "auto":
            raise NotImplementedError(
                'dtype policy "auto" (ZOO_DTYPE_POLICY) is resolved by the '
                "config oracle, which is not ported yet (ROADMAP queue 1 "
                'item 19); set a concrete policy such as "bf16_mixed"')
        return with_dtype_policy(plan, policy)

    def train(self, train_set: FeatureSet, batch_size: int = 32,
              nb_epoch: int | None = None,
              end_trigger: ZooTrigger | None = None,
              checkpoint_trigger: ZooTrigger | None = None,
              validation_set: FeatureSet | None = None,
              validation_trigger: ZooTrigger | None = None,
              seed: int | None = None, autotune=None, plan=None):
        """Train until ``end_trigger`` (default: ``nb_epoch`` more epochs,
        Keras continuation semantics; checked at each epoch boundary)
        with every step under ``plan`` (a ``ShardingPlan`` or name;
        ``None`` defers to the estimator's plan, then
        ``ZOO_SHARDING_PLAN``, then ``dp``).  The optimizer state persists
        across calls, so a second fit continues the moments and the step
        count.  With a checkpointer the fit saves at
        ``checkpoint_trigger`` (default ``EveryEpoch``), resumes from
        ``LATEST`` and retries failures from it.

        ``autotune``: ``True`` (or ``ZOO_AUTOTUNE=1``, which ``None``
        defers to) turns on the closed-loop tuner (feature/autotune.py):
        the train set goes through the prefetch plane (from the
        configured knobs, or workers=1, depth=1 when prefetch is off and
        the set has host work to hide) and a controller thread resizes it
        online while the steps a dispatch hill-climb at dispatch
        boundaries, the loss trajectory bit for bit K=1's.  An
        ``AutotuneController`` instance is shared across fits (and keeps
        running); ``False`` turns it off whatever the environment."""
        plan = self._resolve_plan(plan)
        # validation runs under the estimator's own plan, as in the
        # reference; resolved only when there is a validation set
        eval_plan = (self._resolve_plan() if validation_set is not None
                     else None)
        k = self._steps_per_dispatch()
        if end_trigger is None:
            end_trigger = MaxEpoch(
                self.epoch - 1 + (nb_epoch if nb_epoch is not None else 10))
        if checkpoint_trigger is None and self._ckpt is not None:
            checkpoint_trigger = EveryEpoch()
        if validation_set is not None and validation_trigger is None:
            validation_trigger = EveryEpoch()
        seed = self.ctx.seed if seed is None else seed
        if self.ctx.config.use_pallas is False:
            logger.info("ZOO_USE_PALLAS=0: this fit's kernel scopes take "
                        "their plain PyTorch paths (plan %s)", plan.name)
        params, state = self.model.build_params()
        casts = self.compute_casts(plan, params)
        eval_casts = None
        if eval_plan is not None:
            eval_casts = self.compute_casts(eval_plan, params)
        self._plan_record = {"name": plan.name,
                             "dtype_policy": plan.dtype_policy_str()}
        opt_state = (self._opt_state if self._opt_state is not None
                     else self.optimizer.init(params))
        params, opt_state, state = self._own(params, opt_state, state)
        self._buffers = (params, opt_state, state)
        self._publish_plan_gauges(plan, params)
        start = (self.epoch, 0)
        resumed = self._ckpt.latest() if self._ckpt else None
        if resumed is not None:
            start, seed = self._resume(resumed, plan, params, opt_state,
                                       state)
        train_set, controller, own_controller, attached_set = \
            self._data_plane(train_set, autotune)
        read_ahead = None
        if isinstance(train_set, ShardedFeatureSet):
            # a prefetched set reads ahead on its pipeline's pool instead
            from concurrent.futures import ThreadPoolExecutor

            read_ahead = ThreadPoolExecutor(1, thread_name_prefix="zoo-ra")
            train_set.set_read_ahead(read_ahead)
        if controller is not None:
            tag = "" if plan.name == "dp" else f"_{plan.name}"
            controller.set_feature_label(f"train_step{tag}")
        run = _Run(self, train_set, batch_size, seed, plan, casts, k,
                   end_trigger, checkpoint_trigger, validation_set,
                   validation_trigger, eval_plan, eval_casts, controller)
        try:
            self._train_with_retries(run, start)
        finally:
            if read_ahead is not None:
                train_set.set_read_ahead(None)
                read_ahead.shutdown(wait=True)
            if attached_set is not None:
                # the attachment was for this fit only
                attached_set._controller = None
            if own_controller:
                # a caller's controller keeps running across fits
                controller.stop()
        # the buffers the last dispatch updated: a replay of a capture made
        # on other buffers (``warmup``'s) updates that capture's own
        params, opt_state, state = self._buffers
        self.model.params = params
        self.model.state = state
        self._opt_state = opt_state
        if self._ckpt is not None:
            # the process may exit right after fit: the last snapshot must
            # be complete (and a deferred write error raised)
            self._ckpt._wait()
        return self

    def _data_plane(self, train_set, autotune):
        """The train set through the host data plane for one fit (the
        reference's, estimator.py:1171-1220): (the set to iterate, the
        autotune controller or None, whether this fit owns it, the
        caller's prefetched set the controller was attached to or None).
        With neither ``ZOO_PREFETCH_WORKERS`` nor autotune the set is
        returned as it is and no thread is made."""
        cfg = self.ctx.config
        controller, own = None, False
        auto = autotune if autotune is not None else cfg.autotune
        if auto:
            from analytics_zoo_tpu_torch.feature.autotune import (
                AutotuneController,
            )
            if isinstance(auto, AutotuneController):
                controller = auto
            else:
                controller = AutotuneController.from_config(cfg)
                own = True
        if not cfg.prefetch_workers and controller is None:
            return train_set, None, False, None
        from analytics_zoo_tpu_torch.feature.prefetch import (
            PrefetchFeatureSet,
            worth_prefetching,
        )
        if isinstance(train_set, PrefetchFeatureSet):
            if controller is not None and train_set._controller is None:
                # attached for this fit only: a later fit without autotune
                # on the same set must not find this fit's controller
                train_set._controller = controller
                return train_set, controller, own, train_set
        elif cfg.prefetch_workers or worth_prefetching(train_set):
            # under autotune with prefetch off, from the worst case
            # (workers=1, depth=1), and only for a set with host work to
            # hide; an explicit ZOO_PREFETCH_WORKERS always wraps
            train_set = PrefetchFeatureSet(
                train_set,
                depth=cfg.prefetch_depth if cfg.prefetch_workers else 1,
                workers=cfg.prefetch_workers or 1, controller=controller)
        return train_set, controller, own, None

    def _resume(self, resumed: dict, plan, params, opt_state, state):
        """Restore ``resumed`` (a checkpoint payload) into the fit's
        buffers in place, after the dtype-policy guard; returns ((epoch,
        next batch), seed)."""
        from analytics_zoo_tpu_torch.convert import load_opt_flat_

        saved_plan = resumed.get("plan") or {}
        saved_policy = saved_plan.get("dtype_policy")
        if saved_policy is not None \
                and saved_policy != plan.dtype_policy_str():
            if os.environ.get("ZOO_DTYPE_RESUME", "").strip().lower() \
                    in ("cast", "force"):
                logger.warning(
                    "resuming checkpoint trained under dtype policy %r "
                    "into plan %r with policy %r (ZOO_DTYPE_RESUME): "
                    "casting on resume", saved_policy, plan.name,
                    plan.dtype_policy_str())
            else:
                raise ValueError(
                    f"checkpoint was trained under dtype policy "
                    f"{saved_policy!r} but this fit's plan {plan.name!r} "
                    f"declares {plan.dtype_policy_str()!r}; resume with a "
                    f"matching plan (mixed_precision(), ZOO_DTYPE_POLICY) "
                    f"or set ZOO_DTYPE_RESUME=cast to cast deliberately")
        if saved_plan and (saved_plan.get("name") != plan.name
                           or saved_plan.get("mesh") != {"data": 1}):
            logger.info("resuming a checkpoint of plan=%s mesh=%s into "
                        "plan=%s on one device", saved_plan.get("name"),
                        saved_plan.get("mesh"), plan.name)
        self.global_step = int(resumed["global_step"])
        with torch.no_grad():
            _restore_(params, resumed["params"])
            _restore_(state, resumed["state"])
            load_opt_flat_(self.optimizer, opt_state, resumed["opt_flat"],
                           self.global_step)
        start = (int(resumed["epoch"]), int(resumed["next_batch"]))
        logger.info("resumed from checkpoint @ step %d (epoch %d.%d)",
                    self.global_step, *start)
        return start, int(resumed["seed"])

    def _train_with_retries(self, run, start):
        """The retry-from-checkpoint loop (reference estimator.py:
        1372-1429; Topology.scala:1171-1253): ``KeyboardInterrupt``,
        ``ValueError`` and ``TypeError`` are raised at once; any other
        exception is retried from ``LATEST`` up to
        ``ZOO_FAILURE_RETRY_TIMES`` times, then raised."""
        retries = 0
        retry_times = int(self.ctx.config.failure_retry_times)
        while True:
            try:
                run.loop(start, *self._buffers)
                return
            except (KeyboardInterrupt, ValueError, TypeError):
                raise
            except Exception:
                retries += 1
                if self._ckpt is None or retries > retry_times:
                    raise
                logger.exception(
                    "training failed; retry %d/%d from latest checkpoint",
                    retries, retry_times)
                # the steps that ran before the fault keep their losses
                # (a device fault raises again here, and is not retried)
                run.flush()
                resumed = self._ckpt.latest()
                if resumed is None:
                    raise
                start, _ = self._resume(resumed, run.plan, *self._buffers)
                # the failed attempt's records after the checkpoint are
                # trained again
                self.loss_log = [(i, v) for i, v in self.loss_log
                                 if i <= self.global_step]
                self.history = [h for h in self.history
                                if h["epoch"] < start[0]]

    def _checkpoint_plan(self, plan, params, opt_flat) -> dict:
        """The checkpoint's plan record: the reference's keys, with the
        replicated (empty) spec list of each leaf that ``dp`` writes."""
        return {"name": plan.name, "mesh": {"data": 1},
                "param_specs": [[] for _ in tree_leaves(params)],
                "opt_specs": [[] for _ in opt_flat],
                "dtype_policy": plan.dtype_policy_str()}

    def _on_iteration(self, run, tstate, params, opt_state, state, epoch,
                      next_batch):
        """Validation, then the checkpoint, where their triggers hold (the
        reference's ``_on_iteration``): once per dispatch and at each
        epoch boundary."""
        if run.validation_set is not None \
                and run.validation_trigger is not None \
                and run.validation_trigger(tstate):
            results = self._evaluate_with(params, state, run.validation_set,
                                          run.batch_size, run.eval_casts,
                                          run.eval_plan)
            tstate.score = next(
                (v for k, v in results.items() if k != "loss"),
                -results.get("loss", 0.0))
            logger.info("validation @ step %d: %s", tstate.iteration,
                        results)
            if self._writers:
                for key, v in results.items():
                    self._writers[1].add_scalar(key, v, tstate.iteration)
        if run.checkpoint_trigger is not None and self._ckpt is not None \
                and run.checkpoint_trigger(tstate):
            from analytics_zoo_tpu_torch.convert import opt_flat_leaves

            opt_flat = opt_flat_leaves(self.optimizer, opt_state)
            self._ckpt.save(tstate.iteration, dict(
                params=params, state=state, opt_flat=opt_flat,
                global_step=tstate.iteration, epoch=epoch,
                next_batch=next_batch, seed=run.seed,
                plan=self._checkpoint_plan(run.plan, params, opt_flat)))

    def evaluate(self, val_set: FeatureSet, batch_size: int = 32) -> dict:
        """Loss and metrics over ``val_set``, unshuffled, every record
        counted once, under the estimator's plan (a fit's ``plan=`` does
        not carry over, as in the reference)."""
        if getattr(self.model, "params", None) is None \
                and self.global_step == 0:
            logger.warning(
                "evaluate() called before any training: materializing "
                "fresh random weights; metrics reflect an untrained model")
        params, state = self.model.build_params()
        plan = self._resolve_plan()
        return self._evaluate_with(params, state, val_set, batch_size,
                                   self.compute_casts(plan, params), plan)

    def warmup(self, batch: dict, device_transform=None,
               steps_per_dispatch: int | None = None, plan=None) -> dict:
        """Capture the train steps before the first real batch (the
        reference's ``warmup``, estimator.py:1863-1940): the K=1 step and,
        when ``steps_per_dispatch`` (default: the context's
        ``ZOO_STEPS_PER_DISPATCH``) is K > 1, the K-step one, each by one
        dispatch on ``batch`` (an example host batch ``{"x": ..., "y":
        ...}`` of the batch size fit will use) against fresh buffers: the
        model's parameters and the optimizer state are left untouched.  A
        later ``fit`` under the same plan replays these captures;
        ``device_transform`` must be the one the train set carries
        (``train_set.device_transform``: the step cache keys on it).
        Returns ``{label: seconds}``, each dispatch's time to ready (on the
        card its eager run and its capture; on the CPU the eager step)."""
        plan = self._resolve_plan(plan)
        k = self._steps_per_dispatch(steps_per_dispatch)
        params, state = self.model.build_params()
        device = self.model.device
        casts = self.compute_casts(plan, params)
        params, opt_state, state = (
            tree_map(torch.clone, params),
            self.optimizer.in_layout(self.optimizer.init(params)),
            tree_map(torch.clone, state))
        out = {}
        for kk in sorted({1, k}):
            step = self._train_step_for(kk, plan, device_transform)
            t0 = time.perf_counter()
            res = step(params, opt_state, state,
                       self._keys(kk, device, self.ctx.seed, 0),
                       [_to_device(batch, device) for _ in range(kk)], casts)
            res[-1].tolist()  # ready: the dispatch has run
            out[step.label] = time.perf_counter() - t0
            params, opt_state, state = res[:3]
        logger.info("warmup captured %s", out)
        return out

    def measure_pure_step(self, batch: dict, n_steps: int = 20,
                          device_transform=None) -> float:
        """Seconds a step of the K=1 train step (the fit's, through the
        same cache, captured on the card) on a device-resident ``batch``,
        averaged over ``n_steps`` after a warm step (the reference's
        ``measure_pure_step``, estimator.py:1802): the "pure step" half of
        an end-to-end against compute split, whose difference is the
        infeed the feeder failed to hide.  It runs on copies of the
        parameters, optimizer and model state, so the model is untouched.
        The warm step's seconds (the capture, the first time a signature
        is seen; 0.0 after) go to ``last_probe_warmup_seconds``."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        plan = self._resolve_plan()
        params, state = self.model.build_params()
        device = self.model.device
        casts = self.compute_casts(plan, params)
        params, opt_state, state = (
            tree_map(torch.clone, params),
            self.optimizer.in_layout(self.optimizer.init(params)),
            tree_map(torch.clone, state))
        step = self._train_step_for(1, plan, device_transform)
        on_device = [_to_device(batch, device)]
        args = (params, opt_state, state, self._keys(1, device, 0, 0),
                on_device, casts)
        seen = step._key(args, {}) in step._exes
        t0 = time.perf_counter()
        params, opt_state, state, loss = step(*args)
        loss.tolist()  # ready: the warm step has run
        self.last_probe_warmup_seconds = (
            0.0 if seen else time.perf_counter() - t0)
        t0 = time.perf_counter()
        for i in range(n_steps):
            params, opt_state, state, loss = step(
                params, opt_state, state, self._keys(1, device, 0, i + 1),
                on_device, casts)
        loss.tolist()
        return (time.perf_counter() - t0) / n_steps

    def eval_step(self, params, state, batch, casts=None,
                  device_transform=None) -> list:
        """One batch's statistics (the reference's ``eval_step``,
        estimator.py:1053-1098): ``device_transform`` first when there is
        one, then the forward with the compute casts of
        ``casts`` (:meth:`compute_casts`; None: the context's
        ``compute_dtype``), predictions up to f32, the rows past
        ``batch["n_valid"]`` (a device scalar; a batch without it, as a
        sharded set yields, counts every row) masked out, then the loss's
        (sum, count) and each metric's ``batch_stats``, all on the
        device.  The state stays as stored (f32 running statistics)."""
        casts = casts or (None, self.ctx.compute_dtype)
        with torch.no_grad():
            if device_transform is not None:
                batch = device_transform(batch)
            preds, _ = self.model.forward(
                _cast_params(params, casts),
                cast_floats(batch["x"], casts[1]), state=state,
                training=False)
            preds = cast_floats(preds, torch.float32)
            first = preds[0] if isinstance(preds, list) else preds
            mask = torch.ones(first.shape[0], device=first.device)
            if "n_valid" in batch:
                mask = (torch.arange(first.shape[0], device=first.device)
                        < batch["n_valid"]).float()
            stats = []
            if self.loss is not None and "y" in batch:
                per = self.loss(batch["y"], preds)
                stats.append(((per * mask).sum(), mask.sum()))
            for m in self.metrics:
                stats.append(m.batch_stats(batch["y"], preds, mask=mask))
        return stats

    def _evaluate_with(self, params, state, val_set, batch_size=32,
                       casts=None, plan=None, step=None) -> dict:
        """Loss and metrics over ``val_set``: each batch through the
        planned eval step (``step``, default :meth:`eval_step` under
        ``plan`` through ``compile_step``, captured on the card), its
        statistics summed on the device in batch order, ``finalize`` on
        the host at the end; the set's ``device_transform`` runs inside the
        step."""
        device = self.model.device
        step = step or self._eval_step_for(
            self._resolve_plan(plan),
            getattr(val_set, "device_transform", None))
        accum = None
        for batch in val_set.batches(batch_size, shuffle=False,
                                     drop_last=False, pad_to_batch=1):
            batch = _to_device(batch, device)
            with step.lock:  # the next replay overwrites the statistics
                stats = step(params, state, batch, casts)
                accum = [[s.clone() for s in g] for g in stats] \
                    if accum is None else [
                        [a + b for a, b in zip(ga, gb)]
                        for ga, gb in zip(accum, stats)]
        results = {}
        idx = 0
        if self.loss is not None:
            num, den = accum[idx]
            results["loss"] = float(num) / max(float(den), 1e-12)
            idx += 1
        for m in self.metrics:
            results[m.name] = m.finalize([s.cpu().numpy()
                                          for s in accum[idx]])
            idx += 1
        return results


class _Run:
    """One fit's settings and its epoch loop (the reference's
    ``_train_loop``, estimator.py:1431-1696)."""

    def __init__(self, est, train_set, batch_size, seed, plan, casts, k,
                 end_trigger, checkpoint_trigger, validation_set,
                 validation_trigger, eval_plan, eval_casts, controller=None):
        self.est, self.train_set = est, train_set
        # the autotune controller: K per chunk, a measured dispatch each
        self.controller = controller
        self.k_fn = controller.current_k if controller is not None \
            else lambda: self.k
        self.device_transform = getattr(train_set, "device_transform", None)
        self.batch_size, self.seed, self.plan, self.casts = (
            batch_size, seed, plan, casts)
        self.k, self.end_trigger = k, end_trigger
        self.checkpoint_trigger = checkpoint_trigger
        self.validation_set = validation_set
        self.validation_trigger = validation_trigger
        self.eval_plan, self.eval_casts = eval_plan, eval_casts
        # this epoch's losses on the device, unread: (buffer, count, the
        # iteration of the first)
        self.pending = None

    def flush(self) -> list:
        """Read this epoch's losses (one host sync) into ``loss_log`` and
        the ``Loss`` summaries; returns them."""
        if self.pending is None:
            return []
        losses, done, first = self.pending
        self.pending = None
        values = losses[:done].tolist()
        logged = [(first + i, v) for i, v in enumerate(values)]
        self.est.loss_log.extend(logged)
        if self.est._writers:
            for i, v in logged:
                self.est._writers[0].add_scalar("Loss", v, i)
        return values

    def _record_dispatch(self, step_metrics, flight, straggler, health,
                         epoch, n, data_wait_s, dispatch_s, step_s) -> None:
        """One dispatch's telemetry, as the reference's loop records it:
        the step breakdown, the heartbeat, one ``step`` flight record, and
        straggler detection on the per-step time (a K-step dispatch is
        about K times a single one)."""
        est = self.est
        step_metrics.record_step(data_wait_s, dispatch_s, step_s,
                                 self.batch_size * n, steps=n)
        health.heartbeat("train_loop")
        flight.record(
            "step", loop="train", step=est.global_step, epoch=epoch,
            data_wait_s=round(data_wait_s, 6),
            dispatch_s=round(dispatch_s, 6), step_s=round(step_s, 6),
            **({"fused_steps": n} if n > 1 else {}))
        if straggler.observe(step_s / n):
            step_metrics.stragglers.inc()
            flight.record(
                "straggler", loop="train", step=est.global_step,
                step_s=round(step_s, 6), per_step_s=round(step_s / n, 6),
                rolling_p50_s=round(straggler.rolling_p50(), 6))

    def loop(self, start, params, opt_state, state) -> None:
        """Epochs from ``start`` = (epoch, first batch) until the end
        trigger holds, updating the buffers in place."""
        est = self.est
        device = est.model.device
        pin = torch.device(device).type == "cuda"
        epoch, start_batch = start
        tstate = TrainingState(epoch=epoch, iteration=est.global_step)
        per_epoch = self.train_set.steps_per_epoch(self.batch_size)
        profile = _Profile(est, device)
        # Observability (the reference's train loop): children resolved
        # once here, so a dispatch costs a handful of host-side observe
        # and inc calls around the replay (shared no-ops under
        # ZOO_METRICS=0); the scrape server (ZOO_METRICS_PORT), the
        # flight recorder's crash dump (ZOO_FLIGHT_DIR), the train_loop
        # heartbeat and straggler detection on the per-step time
        step_metrics = StepMetrics()
        maybe_start_from_env()
        flight = get_flight_recorder().install()
        straggler = StragglerDetector()
        health = get_health()
        # the first dispatch of a signature is its capture: the silence
        # budget covers it
        health.register("train_loop", stale_after=600.0)
        try:
            while not self.end_trigger(tstate):
                t0 = time.perf_counter()
                # every step's loss, read once at the epoch boundary
                losses = torch.empty(max(per_epoch - start_batch, 0),
                                     dtype=torch.float32, device=device)
                done = 0
                bi = start_batch
                batches = self.train_set.batches(
                    self.batch_size, shuffle=True, seed=self.seed,
                    epoch=epoch, drop_last=True, start_batch=start_batch)
                # the infeed thread beats per chunk and while it waits on a
                # full queue; it unregisters the component when it ends
                health.register("infeed", stale_after=60.0)
                feeder = _DeviceFeeder(
                    _chunks_dynamic(batches, self.k_fn),
                    lambda chunk: [_stage(b, pin) for b in chunk],
                    depth=est.ctx.config.infeed_depth,
                    heartbeat=lambda: health.heartbeat("infeed"),
                    on_exit=lambda: health.unregister("infeed"))
                try:
                    t_iter0 = time.perf_counter()
                    for chunk in feeder:
                        t_data = time.perf_counter()
                        n = len(chunk)
                        profile.before(est.global_step)
                        # host-side launch or replay only: device time
                        # shows in the ZOO_PROFILE_DIR trace
                        with span("zoo.train.step_dispatch"):
                            params, opt_state, state, out = \
                                est._train_step_for(
                                    n, self.plan, self.device_transform)(
                                    params, opt_state, state,
                                    est._keys(n, device, self.seed,
                                              est.global_step),
                                    [_upload(b, device) for b in chunk],
                                    self.casts)
                        t_disp = time.perf_counter()
                        est._buffers = (params, opt_state, state)
                        losses[done:done + n].copy_(out)
                        done += n
                        self.pending = (losses, done, est.global_step + 1 - (
                            done - n))
                        bi += n
                        est.global_step += n
                        profile.after(est.global_step)
                        tstate.iteration = est.global_step
                        tstate.epoch_finished = False
                        tstate.loss = losses[done - 1]
                        est._on_iteration(self, tstate, params, opt_state,
                                          state, epoch, bi)
                        step_s = time.perf_counter() - t_iter0
                        self._record_dispatch(
                            step_metrics, flight, straggler, health, epoch,
                            n, t_data - t_iter0, t_disp - t_data, step_s)
                        if self.controller is not None:
                            # one measured dispatch for the K hill-climb
                            self.controller.observe_dispatch(n, step_s)
                        t_iter0 = time.perf_counter()
                finally:
                    feeder.stop()
                # the epoch boundary: the one host sync of the loop
                values = self.flush()
                tstate.loss = values[-1] if values else None
                dt = time.perf_counter() - t0
                throughput = len(values) * self.batch_size / max(dt, 1e-9)
                logger.info("epoch %d done: loss=%s, %.1f records/s, "
                            "step=%d", epoch, tstate.loss, throughput,
                            est.global_step)
                est.history.append({"epoch": epoch, "loss": tstate.loss,
                                    "throughput": throughput})
                if est._writers:
                    est._writers[0].add_scalar("Throughput", throughput,
                                               est.global_step)
                step_metrics.record_epoch(epoch, throughput)
                record_device_memory()  # no-op without a CUDA device
                epoch += 1
                start_batch = 0
                tstate.epoch = epoch
                tstate.epoch_finished = True
                est._on_iteration(self, tstate, params, opt_state, state,
                                  epoch, 0)
        finally:
            profile.close()
        # finished on purpose, not wedged (a failed fit leaves it
        # registered, so /healthz goes stale, as in the reference)
        health.unregister("train_loop")
        est.epoch = epoch
