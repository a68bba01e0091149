"""ONNX model loader and exporter.

Counterpart of ``analytics_zoo_tpu/pipeline/api/onnx/`` (the reference's
pyzoo/zoo/pipeline/api/onnx/onnx_loader.py and its op mappers; the
export direction plays the role of ``NetSaver``, Net.scala:264+).

:class:`OnnxNet` is an ordinary layer: its graph is interpreted by the
torch mappers of :mod:`.mapper` inside the step that runs it, so a
captured step or request replays the whole graph.  Float initializers
are trainable parameters keyed by their initializer names (so an
imported model fine-tunes, and ``convert.params_from_jax`` carries the
JAX package's tree across leaf for leaf); integer initializers stay
static numpy values for the shape-consuming ops.  The layout stays ONNX's
NCHW and OIHW.  The protobuf is read and written by the port's own wire
codec (:mod:`.proto`); :func:`export_onnx` (in :mod:`.export`) writes a
trained net out.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer
from analytics_zoo_tpu_torch.pipeline.api.onnx import proto
from analytics_zoo_tpu_torch.pipeline.api.onnx.mapper import MAPPERS
from analytics_zoo_tpu_torch.pipeline.api.onnx.proto import (
    Model,
    decode_model,
)


class _Fixed:
    """Picklable initializer returning a captured array."""

    def __init__(self, arr):
        self.arr = np.asarray(arr)

    def __call__(self, gen, shape, dtype):
        return torch.from_numpy(np.array(self.arr)).to(dtype)


class DeviceConstants:
    """Device copies of a graph's static numpy values, made on first use
    (an eager run, before any capture) and kept: a capture reads them
    where they are and copies nothing from the host.  Keyed on the
    array's identity; the array is kept alive beside its copy."""

    def __init__(self):
        self._copies: dict = {}

    def __call__(self, arr, like):
        key = (id(arr), str(like.device))
        hit = self._copies.get(key)
        if hit is None or hit[0] is not arr:
            t = torch.from_numpy(np.array(arr))
            if t.is_floating_point():
                t = t.to(like.dtype if like.is_floating_point()
                         else torch.float32)
            hit = self._copies[key] = (arr, t.to(like.device))
        return hit[1]

    def __getstate__(self):
        return {"_copies": {}}


class OnnxNet(Layer):
    """An ONNX graph as a layer (reference onnx_loader.py OnnxLoader).

    Float initializers become trainable params (``trainable=False`` keeps
    them in the state instead); integer initializers (shapes, axes,
    indices) stay static.  ONNX's NCHW layout is kept: the convolutions
    and pools run on it directly.
    """

    def __init__(self, model: Model, trainable=True, name=None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.graph = model.graph
        self.opset = model.opset
        self.trainable = trainable
        self._static = {"__opset__": model.opset}  # + int initializers
        self._learn = {}    # float initializers: params/state
        for iname, arr in self.graph.initializers.items():
            if np.issubdtype(arr.dtype, np.floating):
                self._learn[iname] = arr
            else:
                self._static[iname] = arr
        self._constants = DeviceConstants()
        init_names = set(self.graph.initializers)
        self.input_names = [vi.name for vi in self.graph.inputs
                            if vi.name not in init_names]
        self.output_names = [vi.name for vi in self.graph.outputs]
        unsupported = sorted({
            n.op_type for n in self.graph.nodes
            if n.op_type not in MAPPERS
        })
        if unsupported:
            raise NotImplementedError(
                f"ONNX ops without mappers: {unsupported} "
                f"(supported: {sorted(MAPPERS)})"
            )
        # single-input graphs with a static shape drop straight into
        # Sequential without an explicit input_shape
        if self._input_shape is None and len(self.input_names) == 1:
            vi = next(v for v in self.graph.inputs
                      if v.name == self.input_names[0])
            if vi.shape and all(d is not None for d in vi.shape[1:]):
                self._input_shape = tuple(vi.shape[1:])

    def build(self, input_shape):
        for iname, arr in self._learn.items():
            self.add_weight(iname, arr.shape, _Fixed(arr),
                            trainable=self.trainable)

    def call(self, params, inputs, state=None, training=False, rng=None):
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        assert len(xs) == len(self.input_names), (
            f"expected inputs {self.input_names}, got {len(xs)} arrays"
        )
        env: dict = dict(zip(self.input_names, xs))
        env.update(self._static)
        consts = dict(self._static, __tensor__=self._constants)
        weights = params if self.trainable else (state or {})
        for name in self._learn:
            env[name] = weights[name]

        for node in self.graph.nodes:
            fn = MAPPERS[node.op_type]
            args = [env[i] if i else None for i in node.inputs]
            out = fn(node.attrs, consts, *args)
            if isinstance(out, (list, tuple)):
                for oname, o in zip(node.outputs, out):
                    env[oname] = o
            else:
                env[node.outputs[0]] = out

        outs = [env[o] for o in self.output_names]
        result = outs if len(outs) > 1 else outs[0]
        if self.stateful:  # protocol: stateful call returns (out, state)
            return result, state
        return result

    @property
    def stateful(self):
        return not self.trainable

    def init_state(self):
        if self.trainable:
            return super().init_state()
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in self._learn.items()}

    def compute_output_shape(self, input_shape):
        vi = self.graph.outputs[0]
        if vi.shape:
            return tuple(vi.shape)
        raise ValueError("onnx graph output shape unknown")


def load_onnx(path_or_bytes, trainable=True) -> OnnxNet:
    """Load an ONNX model file or bytes into an :class:`OnnxNet`
    (reference onnx_loader.py ``OnnxLoader.load_model``)."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    return OnnxNet(decode_model(data), trainable=trainable)


from analytics_zoo_tpu_torch.pipeline.api.onnx.export import (  # noqa: E402
    export_onnx,
)

__all__ = ["OnnxNet", "load_onnx", "export_onnx", "proto", "MAPPERS"]
