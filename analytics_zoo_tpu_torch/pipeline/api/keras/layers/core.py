"""Core layers of the serving slice: Dense and Dropout.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``.
"""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.common.engine import generator_of
from analytics_zoo_tpu_torch.ops.activations import get_activation
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


class Dense(Layer):
    """Fully connected: ``y = act(x @ W + b)``, kernel shaped (in, out) as
    in the reference.  Applies to the last axis for >2D inputs."""

    def __init__(self, output_dim, init="glorot_uniform", activation=None,
                 bias=True, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.output_dim = int(output_dim)
        self.init = init
        self.activation = get_activation(activation)
        self.bias = bias
        self._config = dict(output_dim=output_dim, init=init, bias=bias)

    def build(self, input_shape):
        in_dim = int(input_shape[-1])
        self.add_weight("kernel", (in_dim, self.output_dim), self.init)
        if self.bias:
            self.add_weight("bias", (self.output_dim,), "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        y = inputs @ params["kernel"]
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Dropout(Layer):
    """Inverted dropout; the identity at inference.  In training the mask
    comes from ``rng``, a ``torch.Generator`` on the inputs' device or a
    train step's ``StepKey`` (the reference draws it with
    ``jax.random.bernoulli``: equal in distribution, not bit for bit)."""

    def __init__(self, p, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.p = float(p)
        self._config = dict(p=p)

    def call(self, params, inputs, state=None, training=False, rng=None):
        if not training or self.p <= 0.0 or rng is None:
            return inputs
        return dropout(inputs, self.p, rng)


def dropout(x, p, rng):
    """Keep each element with probability 1 - p and scale it by 1/(1-p)."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator_of(rng),
                      device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)
