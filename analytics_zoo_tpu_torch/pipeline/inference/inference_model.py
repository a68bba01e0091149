"""Pooled, batched inference runner.

Counterpart of ``analytics_zoo_tpu/pipeline/inference/inference_model.py``
with the same surface and the same batching: each micro-batch is padded
with zero records to a power-of-two bucket and the outputs are sliced back
to the real records.  The reference keeps one compiled XLA executable per
bucket; eager PyTorch has nothing to compile, so the per-bucket map here
records the buckets seen, and ``warmup`` runs one forward per bucket
(which also builds the CUDA kernels before the first request).

``concurrent_num`` bounds in-flight predict calls with a semaphore, and
outputs are copied back to numpy inside it, so the bound covers the
device work.  Telemetry is plain counters on the instance; the metrics
registry comes with the serving-host slice.

``optimize("int8")`` is weight-only (dequantized before each forward, as
in the reference); ``optimize("int8", calibration_data=x)`` builds a
calibrated :class:`~analytics_zoo_tpu_torch.pipeline.inference.quantize.
Int8Model` whose int8 ``apply`` hooks are installed around each forward.
The reference bakes those hooks into one compiled executable per bucket;
here every calibrated forward installs them under the global
``HOOK_LOCK``, so calibrated forwards run one at a time.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
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
        self._params = None
        self._state = None
        self._lock = threading.Lock()
        self._buckets = {}  # guarded-by: _lock -- input-shape key -> bucket
        self._quantized = False
        self._bf16 = False
        self._int8_model = None  # calibrated int8 (optimize + calibration)
        # Telemetry: records served, and per bucket the micro-batch count
        # and total/max run seconds (host clock around work that ends in a
        # device-to-host copy)
        self.records = 0
        self.bucket_stats: dict[int, dict] = {}  # guarded-by: _lock

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
        with self._lock:
            self._buckets = {}
        self._quantized = False
        self._bf16 = False
        self._int8_model = None
        return self

    def optimize(self, precision: str = "int8",
                 calibration_data=None) -> "InferenceModel":
        """``int8``: weight-only per-channel quantization, dequantized before
        each forward; with ``calibration_data`` (representative inputs, one
        array) the activations are calibrated too and the top-level Dense
        layers run int8 x int8 -> int32; ``bf16``: weights (and floating
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
        with self._lock:
            self._buckets = {}
        return self

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _forward(self, xs: Sequence[np.ndarray]):
        device = self._net.device
        params = self._params
        int8 = self._int8_model
        if self._quantized and int8 is None:
            params = dequantize_params(params)
        ts = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in xs]
        if self._bf16:
            ts = [t.to(torch.bfloat16) if t.is_floating_point() else t
                  for t in ts]
        x = ts[0] if len(ts) == 1 else ts
        if int8 is not None:
            # the hooked layers read their int8 kernels from the hooks;
            # params supplies the float leaves (biases, other layers)
            return int8.forward(x)
        with torch.inference_mode():
            out, _ = self._net.forward(params, x, state=self._state,
                                       training=False)
        if self._bf16:
            out = tree_map(lambda o: o.float(), out)
        return out

    def _note_bucket(self, xs: Sequence[np.ndarray]) -> None:
        key = tuple((a.shape, str(a.dtype)) for a in xs)
        with self._lock:
            self._buckets.setdefault(
                key, int(xs[0].shape[0]) if np.ndim(xs[0]) else 0)

    def warmup(self, input_shapes, dtype=np.float32,
               batch_sizes=(1,)) -> None:
        """One forward per bucket that the given batch sizes round up to,
        so the first request finds its bucket warm."""
        shapes = input_shapes
        if shapes and not isinstance(shapes[0], (list, tuple)):
            shapes = [shapes]
        for b in sorted({_bucket(int(b), self.max_batch)
                         for b in batch_sizes}):
            xs = [np.zeros((b,) + tuple(s), dtype) for s in shapes]
            self._note_bucket(xs)
            self._forward(xs)

    # ------------------------------------------------------------------
    # doPredict
    # ------------------------------------------------------------------
    def predict(self, inputs, batch_size: int | None = None):
        """Batched inference.  Pads each micro-batch to a power-of-two
        bucket, bounded by the concurrency semaphore."""
        if self._net is None:
            raise RuntimeError("no model loaded")
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [np.asarray(a) for a in xs]
        n = xs[0].shape[0]
        if n == 0:
            # a padded singleton through the bucket-1 forward learns the
            # output shape, which is returned empty
            dummy = [np.zeros((1,) + a.shape[1:], a.dtype) for a in xs]
            self._note_bucket(dummy)
            out = self._forward(dummy)
            if isinstance(out, (list, tuple)):
                return [np.zeros((0,) + tuple(o.shape[1:]),
                                 _numpy_dtype(o)) for o in out]
            return np.zeros((0,) + tuple(out.shape[1:]), _numpy_dtype(out))
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
            self._note_bucket(chunk)
            with self._sem:
                t0 = time.perf_counter()
                out = self._forward(chunk)
                # copy back inside the semaphore so concurrent_num bounds
                # in-flight device work (kernel launches are asynchronous)
                if isinstance(out, (list, tuple)):
                    out = [o.cpu().numpy()[:m] for o in out]
                else:
                    out = out.cpu().numpy()[:m]
                self._record(b, m, time.perf_counter() - t0)
            outs.append(out)
        if isinstance(outs[0], list):
            return [np.concatenate([o[i] for o in outs])
                    for i in range(len(outs[0]))]
        return np.concatenate(outs, axis=0)

    def _record(self, bucket: int, m: int, seconds: float) -> None:
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


def _numpy_dtype(t):
    return torch.empty((), dtype=t.dtype).numpy().dtype


class AbstractInferenceModel(InferenceModel):
    """Java-POJO-style subclassable surface."""
