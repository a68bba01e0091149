"""Tensor-manipulation layers (the part ResNet's stems use).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/tensor_ops.py``;
only ``SpaceToDepth`` is ported so far, the rest waits for its slice
(ROADMAP queue 1, item 3).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


class SpaceToDepth(Layer):
    """Channels-last space-to-depth: (B, H, W, C) -> (B, H/b, W/b,
    b*b*C), in TensorFlow's channel order (block row, block column,
    channel)."""

    def __init__(self, block_size=2, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.block_size = int(block_size)
        self._config = dict(block_size=self.block_size)

    def call(self, params, inputs, state=None, training=False, rng=None):
        b = self.block_size
        n, h, w, c = inputs.shape
        if h % b or w % b:
            raise ValueError(
                f"spatial dims {(h, w)} not divisible by block {b}")
        x = inputs.reshape(n, h // b, b, w // b, b, c)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h // b, w // b, b * b * c)

    def compute_output_shape(self, input_shape):
        b = self.block_size
        n, h, w, c = input_shape
        if h % b or w % b:
            raise ValueError(
                f"spatial dims {(h, w)} not divisible by block {b}")
        return (n, h // b, w // b, b * b * c)
