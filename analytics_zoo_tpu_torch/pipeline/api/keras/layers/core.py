"""Core layers: Dense, Dropout, and the shape and activation layers
(Activation, Flatten, Reshape, Permute, RepeatVector, Identity, Squeeze,
ExpandDim).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``.
``Flatten`` flattens a channels-last activation in (..spatial.., channel)
order, as the reference does, so a Dense kernel after it carries over.
The stochastic and weighted extras (SpatialDropout*, GaussianNoise,
GaussianDropout, Masking, Highway, Select, MaxoutDense, SparseDense) wait
for their slice (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import numpy as np
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


class Activation(Layer):
    def __init__(self, activation, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.activation = get_activation(activation)
        self._config = dict(activation=str(activation))

    def call(self, params, inputs, state=None, training=False, rng=None):
        return self.activation(inputs)


class Flatten(Layer):
    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs.reshape(inputs.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], int(np.prod(input_shape[1:])))


class Reshape(Layer):
    """Reshape the non-batch dims; one dim may be -1."""

    def __init__(self, target_shape, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.target_shape = tuple(int(d) for d in target_shape)
        self._config = dict(target_shape=self.target_shape)

    def _resolve(self, input_shape):
        in_elems = int(np.prod(input_shape[1:]))
        tgt = list(self.target_shape)
        if -1 in tgt:
            known = int(np.prod([d for d in tgt if d != -1]))
            tgt[tgt.index(-1)] = in_elems // known
        return tuple(tgt)

    def call(self, params, inputs, state=None, training=False, rng=None):
        tgt = self._resolve((None,) + tuple(inputs.shape[1:]))
        return inputs.reshape((inputs.shape[0],) + tgt)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._resolve(input_shape)


class Permute(Layer):
    """Permute the non-batch axes; dims are 1-based (Keras-1)."""

    def __init__(self, dims, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dims = tuple(int(d) for d in dims)
        self._config = dict(dims=self.dims)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(
            input_shape[d] for d in self.dims
        )


class RepeatVector(Layer):
    """(b, f) -> (b, n, f)."""

    def __init__(self, n, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.n = int(n)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.repeat_interleave(inputs[:, None, :], self.n, dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.n, input_shape[1])


class Identity(Layer):
    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs


class Squeeze(Layer):
    """Squeeze singleton dims; dims are 0-based, the batch included."""

    def __init__(self, dims, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dims = (dims,) if isinstance(dims, int) else tuple(dims)

    def call(self, params, inputs, state=None, training=False, rng=None):
        for d in sorted((d % inputs.dim() for d in self.dims), reverse=True):
            if inputs.shape[d] != 1:
                raise ValueError(f"cannot squeeze dim {d} of size "
                                 f"{inputs.shape[d]}")
            inputs = inputs.squeeze(d)
        return inputs

    def compute_output_shape(self, input_shape):
        nd = len(input_shape)
        drop = {d % nd for d in self.dims}
        return tuple(s for i, s in enumerate(input_shape) if i not in drop)


class ExpandDim(Layer):
    def __init__(self, dim, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dim = int(dim)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs.unsqueeze(self.dim)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        dim = self.dim if self.dim >= 0 else len(shape) + 1 + self.dim
        shape.insert(dim, 1)
        return tuple(shape)
