"""Unified model import surface.

Counterpart of ``analytics_zoo_tpu/pipeline/api/net/__init__.py`` (the
reference's pipeline/api/Net.scala:90-263: ``Net.load``, ``loadBigDL``,
``loadTorch``, ``loadCaffe``, ``loadTF``, plus the pipeline/api/net
package's TFNet and TorchNet).  One ``Net`` facade dispatching to the
per-format loaders; TF imports lazily and raises the reference's
``ImportError`` where it is absent.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.net.tf_net import TFNet  # noqa: F401
from analytics_zoo_tpu_torch.pipeline.api.net.torch_net import (  # noqa: F401
    TorchCriterion,
    TorchNet,
    import_state_dict,
)


class Net:
    """Reference Net.scala:90-263: static loaders per serialized format."""

    @staticmethod
    def load(path):
        """Load a model saved by this framework (``KerasNet.save``;
        reference ``Net.load`` for the zoo/BigDL format)."""
        from analytics_zoo_tpu_torch.pipeline.api.keras.topology import (
            KerasNet,
        )

        return KerasNet.load(path)

    # the reference's loadBigDL is its own-format loader; ours is load()
    load_bigdl = load

    @staticmethod
    def load_torch(path, **kwargs):
        """TorchScript archive -> :class:`TorchNet` (reference
        ``Net.loadTorch``)."""
        return TorchNet.load(path, **kwargs)

    @staticmethod
    def load_tf(path, input_name=None, output_name=None, **kwargs):
        """Frozen GraphDef or SavedModel dir -> :class:`TFNet` (reference
        ``Net.loadTF``)."""
        import os

        if os.path.isdir(path):
            return TFNet.from_saved_model(path, **kwargs)
        if input_name is None or output_name is None:
            raise ValueError(
                "loading a frozen GraphDef requires input_name/output_name"
            )
        return TFNet.from_frozen(path, input_name, output_name, **kwargs)

    @staticmethod
    def load_onnx(path_or_bytes):
        """ONNX model -> :class:`OnnxNet` (reference
        pyzoo/zoo/pipeline/api/onnx loader)."""
        from analytics_zoo_tpu_torch.pipeline.api.onnx import load_onnx

        return load_onnx(path_or_bytes)

    @staticmethod
    def load_caffe(def_path, model_path=None):
        """Caffe prototxt (+ optional caffemodel weights) ->
        :class:`CaffeNet` (reference ``Net.loadCaffe`` ->
        models/caffe CaffeLoader.scala)."""
        from analytics_zoo_tpu_torch.models.caffe import load_caffe

        return load_caffe(def_path, model_path)
