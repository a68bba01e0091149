"""Pooled, batched inference runner.

Counterpart of ``analytics_zoo_tpu/pipeline/inference/inference_model.py``
with the same surface and the same batching: each micro-batch is padded
with zero records to a power-of-two bucket and the outputs are sliced back
to the real records.  The reference compiles one XLA executable per bucket
shape through the compile plane; here each bucket shape gets one planned
forward (``parallel.plan.compile_step``, labelled ``inference_b<bucket>``),
which on the card captures the forward into a CUDA graph on its first call
and replays it on every later one.  ``warmup`` captures every bucket it
names.  The parameters and the model state go into the capture by
reference (never cloned or copied); the micro-batch is written straight
into the capture's static inputs, from numpy through a pinned staging
buffer per input, so the host-to-device copy stays outside the graph.

A replay's outputs are overwritten by the next one, and a model's
captures share one CUDA graph memory pool, so the buckets of one model
form one ``CaptureGroup``: a micro-batch holds its lock from the copy in
until its outputs are on the host.  ``concurrent_num`` bounds in-flight
predict calls with a semaphore, and the outputs are copied back to numpy
inside it.  Telemetry is the reference's registry families:
``zoo_inference_compiles_total{bucket}`` (one a bucket, counted when its
first micro-batch has run: its capture on the card, its first eager
forward on the CPU, under a ``zoo.inference.compile`` span),
``zoo_inference_predict_seconds{bucket}`` (host clock of each predict
micro-batch, from the copy in to the outputs on the host; a bucket's
first micro-batch includes its capture) and ``zoo_inference_records_total``;
plus plain counters on the instance (``records``, ``bucket_stats``) and
the compile plane's ``compile_stats()``.  All of it is recorded on the
host around the replay, never inside a capture.

``optimize("int8")`` is weight-only: the graph dequantizes the weights
before each forward, as the reference's executable does;
``optimize("int8", calibration_data=x)`` builds a calibrated
:class:`~analytics_zoo_tpu_torch.pipeline.inference.quantize.Int8Model`
whose int8 ``apply`` hooks are installed (under the global ``HOOK_LOCK``)
only while a bucket's forward runs in Python: its eager run and its
capture on the card, every call on the CPU.  Replays take no
``HOOK_LOCK``.  Float forwards hold ``HOOK_LOCK`` the same way, so no
capture can see another model's hooks.  ``from_keras_net`` and
``optimize`` drop every capture.

``load_torch`` runs a torch module on the host behind the same
``predict``, the reference's escape hatch for models not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.metrics import get_registry, span
from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
    HOOK_LOCK,
    dequantize_params,
    quantize_model,
    quantize_params,
)


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n (capped)."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


class _Bucket:
    """One bucket shape's planned forward and, once it is captured, the
    capture's static batch inputs with a pinned staging buffer each."""

    def __init__(self, step, bucket: str):
        self.step = step
        self.bucket = bucket  # the ``bucket`` label of its metrics
        self.ran = False     # guarded-by: step.lock
        self.static = None   # guarded-by: step.lock
        self.staging = None  # guarded-by: step.lock


class InferenceModel:
    """Load-once, predict-many inference engine.

    ``predict`` accepts a single ndarray or a list (multi-input models) and
    handles batching and padding internally.  The model runs on the device
    its weights live on (``net.device``).
    """

    def __init__(self, concurrent_num: int = 4, max_batch: int = 1024):
        self.concurrent_num = int(concurrent_num)
        self.max_batch = int(max_batch)
        self._sem = threading.Semaphore(self.concurrent_num)
        self._net = None
        self._torch = None  # a host module from load_torch
        self._params = None
        self._state = None
        self._lock = threading.Lock()
        self._buckets = {}  # guarded-by: _lock -- input-shape key -> bucket
        self._steps = {}  # guarded-by: _lock -- input-shape key -> _Bucket
        self._group = None  # guarded-by: _lock -- the buckets' CaptureGroup
        self._quantized = False
        self._bf16 = False
        self._int8_model = None  # calibrated int8 (optimize + calibration)
        # Telemetry: records served, and per bucket the micro-batch count
        # and total/max run seconds (host clock around work that ends in a
        # device-to-host copy)
        self.records = 0
        self.bucket_stats: dict[int, dict] = {}  # guarded-by: _lock
        reg = get_registry()
        self._m_compiles = reg.counter(
            "zoo_inference_compiles_total",
            "XLA compiles by input shape bucket", ("bucket",))
        self._m_latency = reg.histogram(
            "zoo_inference_predict_seconds",
            "executable run time per micro-batch", ("bucket",))
        self._m_records = reg.counter(
            "zoo_inference_records_total", "records predicted")

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------
    def load(self, path: str, device=None) -> "InferenceModel":
        """Load a model written by ``KerasNet.save``."""
        from analytics_zoo_tpu_torch.pipeline.api.keras.topology import (
            KerasNet,
        )

        return self.from_keras_net(KerasNet.load(path, device=device))

    def from_keras_net(self, net) -> "InferenceModel":
        """Wrap an in-memory model."""
        net.build_params()
        self._net = net
        self._params = net.params
        self._state = net.state
        self._quantized = False
        self._bf16 = False
        self._int8_model = None
        self._drop_captures()
        return self

    def load_torch(self, module, input_shape=None) -> "InferenceModel":
        """Run a torch module on the host behind the same ``predict`` (the
        reference's ``doLoadPyTorch``): the escape hatch for models not
        ported; ported models should use :meth:`load` or
        :meth:`from_keras_net`."""
        module.eval()
        self._torch = module
        self._net = None
        self._drop_captures()
        return self

    def optimize(self, precision: str = "int8",
                 calibration_data=None) -> "InferenceModel":
        """``int8``: weight-only per-channel quantization, dequantized inside
        each forward; with ``calibration_data`` (representative inputs, one
        array) the activations are calibrated too and the top-level Dense
        and conv layers run int8 x int8 -> int32 (the ``int8_conv``
        kernel on the card); ``bf16``: weights (and floating
        inputs) in bfloat16, outputs returned in float32 (calibration data
        is ignored).  Every call starts from the float model."""
        if self._net is None:
            raise RuntimeError("load a model first")
        if precision not in ("int8", "bf16"):
            # validate before changing anything: a bad precision leaves the
            # model as it was
            raise ValueError(f"unknown precision {precision!r}")
        self._int8_model = None
        self._bf16 = False
        if precision == "int8" and calibration_data is not None:
            self._int8_model = quantize_model(self._net, calibration_data)
            self._params = self._int8_model.qparams
            self._quantized = True
        elif precision == "int8":
            self._params = quantize_params(self._net.params)
            self._quantized = True
        else:
            self._params = tree_map(
                lambda a: a.to(torch.bfloat16) if a.is_floating_point()
                else a, self._net.params)
            self._quantized = False
            self._bf16 = True
        self._drop_captures()
        return self

    @staticmethod
    def enable_persistent_compile_cache(cache_dir: str) -> None:
        """Keep what the compile plane builds in ``cache_dir``, so that a
        second process finds it there (the kernel libraries; a CUDA graph
        lives in its process).  Delegates to
        ``common.compile_cache.maybe_enable_persistent_cache``, as
        ``ZOO_COMPILE_CACHE`` does."""
        from analytics_zoo_tpu_torch.common.compile_cache import (
            maybe_enable_persistent_cache,
        )

        maybe_enable_persistent_cache(cache_dir)

    # ------------------------------------------------------------------
    # the planned forward of each bucket
    # ------------------------------------------------------------------
    def _drop_captures(self) -> None:
        from analytics_zoo_tpu_torch.parallel.plan import CaptureGroup

        with self._lock:
            self._buckets = {}
            self._steps = {}
            self._group = CaptureGroup()

    def _forward_fn(self):
        """The forward a bucket's step runs: ``(params, state, xs)`` ->
        outputs, under ``no_grad``, with the model's precision choices."""
        net, quantized = self._net, self._quantized
        int8, bf16 = self._int8_model, self._bf16

        def fwd(params, state, xs):
            # calibrated int8: the hooked layers read their int8 kernels
            # from the hooks (params supplies the float leaves), so there is
            # no dequantization pass
            with (int8.installed() if int8 is not None else HOOK_LOCK), \
                    torch.no_grad():
                if quantized and int8 is None:
                    params = dequantize_params(params)
                if bf16:
                    xs = [x.to(torch.bfloat16) if x.is_floating_point()
                          else x for x in xs]
                x = xs[0] if len(xs) == 1 else list(xs)
                out, _ = net.forward(params, x, state=state, training=False)
                if bf16:
                    out = tree_map(lambda o: o.float(), out)
            return out

        return fwd

    def _bucket_for(self, xs: Sequence[np.ndarray]) -> _Bucket:
        """The bucket shape's :class:`_Bucket`, made on its first use."""
        from analytics_zoo_tpu_torch.common.compile_cache import (
            maybe_enable_persistent_cache,
        )
        from analytics_zoo_tpu_torch.parallel.plan import compile_step

        key = tuple((a.shape, str(a.dtype)) for a in xs)
        with self._lock:
            entry = self._steps.get(key)
            if entry is None:
                b = int(xs[0].shape[0]) if np.ndim(xs[0]) else 0
                self._buckets[key] = b
                # ZOO_COMPILE_CACHE: the kernel libraries a capture loads
                maybe_enable_persistent_cache()
                entry = self._steps[key] = _Bucket(compile_step(
                    self._forward_fn(), label=f"inference_b{b}",
                    ref_argnums=(0, 1), group=self._group), str(b))
        return entry

    def _run(self, xs: Sequence[np.ndarray], m: int):
        """One bucket-sized micro-batch through its bucket's step: the
        outputs of its first ``m`` records as numpy (a list for several
        outputs)."""
        entry = self._bucket_for(xs)
        device = self._net.device
        with entry.step.lock:
            if entry.static is not None:
                # a replay: the batch goes straight into the capture's
                # static inputs, through pinned memory
                for stage, static, a in zip(entry.staging, entry.static,
                                            xs):
                    stage.copy_(torch.from_numpy(np.ascontiguousarray(a)))
                    static.copy_(stage, non_blocking=True)
                batch = entry.static
            else:
                batch = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in xs]
            if entry.ran:
                out = entry.step(self._params, self._state, batch)
            else:
                # the bucket's first micro-batch: its capture on the card
                with span("zoo.inference.compile",
                          args={"bucket": entry.bucket}):
                    out = entry.step(self._params, self._state, batch)
                entry.ran = True
                self._m_compiles.labels(bucket=entry.bucket).inc()
            if entry.static is None and device.type == "cuda":
                captured = entry.step.static_inputs(self._params,
                                                    self._state, batch)
                if captured is not None:
                    entry.static = captured[0][2]
                    entry.staging = [torch.empty(
                        t.shape, dtype=t.dtype, pin_memory=True)
                        for t in entry.static]
            # copied out under the lock: the next replay overwrites them
            if isinstance(out, (list, tuple)):
                return [o.cpu().numpy()[:m] for o in out]
            return out.cpu().numpy()[:m]

    def warmup(self, input_shapes, dtype=np.float32,
               batch_sizes=(1,)) -> None:
        """Capture the forward of every bucket that the given batch sizes
        round up to (one forward each on the CPU), so the first request
        finds its bucket ready.  ``dtype`` is every input's, or a sequence
        of one per input: a bucket is keyed on its inputs' shapes and
        dtypes, so warm it with the dtypes requests bring.  The largest
        bucket is captured first: the smaller ones then take their memory
        from what it freed in the model's shared pool."""
        shapes = input_shapes
        if shapes and not isinstance(shapes[0], (list, tuple)):
            shapes = [shapes]
        dtypes = list(dtype) if isinstance(dtype, (list, tuple)) \
            else [dtype] * len(shapes)
        for b in sorted({_bucket(int(b), self.max_batch)
                         for b in batch_sizes}, reverse=True):
            self._run([np.zeros((b,) + tuple(s), d)
                       for s, d in zip(shapes, dtypes)], b)

    # ------------------------------------------------------------------
    # doPredict
    # ------------------------------------------------------------------
    def predict(self, inputs, batch_size: int | None = None):
        """Batched inference.  Pads each micro-batch to a power-of-two
        bucket, bounded by the concurrency semaphore."""
        if self._torch is not None and self._net is None:
            return self._predict_host(inputs, batch_size)
        if self._net is None:
            raise RuntimeError("no model loaded")
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [np.asarray(a) for a in xs]
        n = xs[0].shape[0]
        if n == 0:
            # a padded singleton through the bucket-1 forward learns the
            # output shape, which is returned empty
            return self._run([np.zeros((1,) + a.shape[1:], a.dtype)
                              for a in xs], 0)
        step = min(batch_size or n, self.max_batch)
        outs = []
        for lo in range(0, n, step):
            chunk = [a[lo:lo + step] for a in xs]
            m = chunk[0].shape[0]
            b = _bucket(m, self.max_batch)
            if b != m:
                chunk = [
                    np.concatenate(
                        [a, np.zeros((b - m,) + a.shape[1:], a.dtype)]
                    )
                    for a in chunk
                ]
            with self._sem:
                t0 = time.perf_counter()
                # ends in the device-to-host copy, so concurrent_num bounds
                # in-flight device work (kernel launches are asynchronous)
                out = self._run(chunk, m)
                self._record(b, m, time.perf_counter() - t0)
            outs.append(out)
        if isinstance(outs[0], list):
            return [np.concatenate([o[i] for o in outs])
                    for i in range(len(outs[0]))]
        return np.concatenate(outs, axis=0)

    def _predict_host(self, inputs, batch_size):
        """``predict`` of a :meth:`load_torch` module, on the host."""
        module = self._torch
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [np.asarray(a) for a in xs]
        n = xs[0].shape[0]
        step = min(batch_size or max(n, 1), self.max_batch)
        outs = []
        for lo in range(0, n, step):
            args = [torch.as_tensor(a[lo:lo + step]) for a in xs]
            with self._sem, torch.no_grad():
                outs.append(module(*args).numpy())
        if not outs:
            with torch.no_grad():
                probe = module(*[torch.as_tensor(
                    np.zeros((1,) + a.shape[1:], a.dtype)) for a in xs])
            return np.zeros((0,) + tuple(probe.shape[1:]),
                            probe.numpy().dtype)
        return np.concatenate(outs, axis=0)

    def _record(self, bucket: int, m: int, seconds: float) -> None:
        self._m_latency.labels(bucket=str(bucket)).observe(seconds)
        self._m_records.inc(m)
        with self._lock:
            self.records += m
            st = self.bucket_stats.setdefault(
                bucket, {"runs": 0, "seconds": 0.0, "max_seconds": 0.0})
            st["runs"] += 1
            st["seconds"] += seconds
            st["max_seconds"] = max(st["max_seconds"], seconds)

    # camelCase aliases matching the reference Java/Scala POJO surface
    doPredict = predict
    doLoad = load


class AbstractInferenceModel(InferenceModel):
    """Java-POJO-style subclassable surface."""
