"""TFNet: TensorFlow graphs inside a net.

Counterpart of ``analytics_zoo_tpu/pipeline/api/net/tf_net.py`` (the
reference's pipeline/api/net/TFNet.scala:53-250, a frozen GraphDef run
through libtensorflow JNI as a BigDL module; forward :173-250, backward
through a TF-made gradient subgraph :278; TFNetForInference.scala for
SavedModels).

The TF function runs on the host: the forward copies its input to the
host, runs TF and copies the output back; the backward computes the
input gradient with ``tf.GradientTape``.  A host round trip cannot sit
inside a CUDA graph, so a net holding a TFNet runs its steps uncaptured
(``host_round_trip``; ``compile_stats`` shows them under labels ending in
``_host``).  Gated on the ``tensorflow`` import, which raises the
reference's ``ImportError`` where TF is absent.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


def _tf():
    try:
        import tensorflow as tf
    except Exception as e:  # pragma: no cover - machines without TF
        raise ImportError(
            "TFNet requires tensorflow, which is not available in this "
            "environment"
        ) from e
    return tf


def _host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy())


class _TFApply(torch.autograd.Function):
    """``tf_fn`` on the host, with its input gradient from a tape."""

    @staticmethod
    def forward(ctx, x, tf_fn):
        tf = _tf()
        ctx.tf_fn = tf_fn
        ctx.save_for_backward(x)
        y = np.asarray(tf_fn(tf.convert_to_tensor(_host(x))))
        return torch.from_numpy(np.array(y)).to(x.device, x.dtype)

    @staticmethod
    def backward(ctx, g):
        tf = _tf()
        (x,) = ctx.saved_tensors
        xt = tf.convert_to_tensor(_host(x))
        with tf.GradientTape() as tape:
            tape.watch(xt)
            y = ctx.tf_fn(xt)
        gx = tape.gradient(y, xt,
                           output_gradients=tf.convert_to_tensor(_host(g)))
        if gx is None:  # no gradient path (the reference zeros gradInput
            #             when there is no backward meta, TFNet.scala:278)
            return torch.zeros_like(x), None
        return torch.from_numpy(np.array(gx)).to(x.device, x.dtype), None


class TFNet(Layer):
    """A frozen TF computation as a layer.

    Construct with any callable ``tf_fn(tf.Tensor) -> tf.Tensor`` (e.g. a
    ``tf.function`` concrete function); classmethods cover the reference's
    load paths: ``from_frozen`` (GraphDef .pb, TFNet.scala:53) and
    ``from_saved_model`` (TFNetForInference.scala).
    """

    #: the layer runs on the host: a step holding it is never captured
    host_round_trip = True

    def __init__(self, tf_fn, output_shape=None, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.tf_fn = tf_fn
        self._fixed_out_shape = (
            tuple(output_shape) if output_shape is not None else None
        )
        self._out_shapes: dict = {}  # per-input-shape cache

    @classmethod
    def from_frozen(cls, graph_def_path, input_name, output_name, **kwargs):
        """Load a frozen GraphDef ``.pb`` (reference TFNet(path) with
        input/output names, TFNet.scala:427-452)."""
        tf = _tf()
        gd = tf.compat.v1.GraphDef()
        with open(graph_def_path, "rb") as f:
            gd.ParseFromString(f.read())

        def imported(*args):
            return tf.compat.v1.import_graph_def(
                gd, input_map={input_name: args[0]},
                return_elements=[output_name],
            )[0]

        wrapped = tf.compat.v1.wrap_function(
            imported,
            [tf.TensorSpec(None, tf.float32)],
        )
        return cls(wrapped, **kwargs)

    @classmethod
    def from_saved_model(cls, export_dir, signature="serving_default",
                         **kwargs):
        """Load a SavedModel (reference TFNetForInference.scala)."""
        tf = _tf()
        sm = tf.saved_model.load(export_dir)
        fn = sm.signatures[signature]

        def call_fn(x):
            out = fn(x)
            if isinstance(out, dict):
                out = next(iter(out.values()))
            return out

        net = cls(call_fn, **kwargs)
        net._saved_model = sm  # keep variables alive
        return net

    @classmethod
    def from_keras(cls, keras_model, **kwargs):
        """Wrap a live tf.keras model (reference TFNet.fromKeras)."""
        return cls(lambda x: keras_model(x, training=False), **kwargs)

    def _infer_out_shape(self, input_shape):
        if self._fixed_out_shape is not None:
            return self._fixed_out_shape
        key = tuple(int(s) for s in input_shape)
        out = self._out_shapes.get(key)
        if out is None:  # shape-dependent graphs get a probe per shape
            tf = _tf()
            y = self.tf_fn(tf.zeros((1,) + key, tf.float32))
            out = self._out_shapes[key] = tuple(
                int(s) for s in y.shape[1:]
            )
        return out

    def build(self, input_shape):
        self._infer_out_shape(input_shape)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._infer_out_shape(input_shape[1:])

    def call(self, params, inputs, state=None, training=False, rng=None):
        _tf()
        if torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{self.name}: a TFNet runs on the host and cannot be "
                "captured; its net's steps run uncaptured")
        return _TFApply.apply(inputs, self.tf_fn)
