"""Core layers: Dense, the dropouts and noises, and the shape,
activation and weighted extras.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``,
every class of it.  ``Flatten`` flattens a channels-last activation in
(..spatial.., channel) order, as the reference does, so a Dense kernel
after it carries over.  The random layers (Dropout, SpatialDropout1D/2D/3D,
GaussianNoise, GaussianDropout) draw from ``rng``'s generator
(``generator_of``: inside a captured train step, a generator the step's
``StepRandomness`` re-seeds before each replay), one draw a call: equal to
the reference's ``jax.random`` draws in distribution, not bit for bit.
``SparseDense`` on a COO triple gathers the kernel's rows for each
nonzero and sums them into their samples with ``index_add`` (atomic on
CUDA: not bitwise from run to run).
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


def dropout(x, p, rng, shape=None):
    """Keep each element with probability 1 - p and scale it by 1/(1-p);
    with ``shape`` (broadcastable to x's) one draw covers each broadcast
    group."""
    keep = 1.0 - p
    mask = torch.rand(x.shape if shape is None else shape,
                      generator=generator_of(rng), device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class _SpatialDropoutND(Dropout):
    """Drops whole channels-last feature maps: one Bernoulli draw a
    (sample, channel), broadcast over the other axes."""

    def call(self, params, inputs, state=None, training=False, rng=None):
        if not training or self.p <= 0.0 or rng is None:
            return inputs
        shape = ((inputs.shape[0],) + (1,) * (inputs.dim() - 2)
                 + (inputs.shape[-1],))
        return dropout(inputs, self.p, rng, shape)


class SpatialDropout1D(_SpatialDropoutND):
    """(B, steps, C) feature-map dropout."""


class SpatialDropout2D(_SpatialDropoutND):
    """NHWC feature-map dropout."""


class SpatialDropout3D(_SpatialDropoutND):
    """NDHWC feature-map dropout."""


class GaussianNoise(Layer):
    """Adds N(0, sigma^2) noise in training."""

    def __init__(self, sigma, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.sigma = float(sigma)

    def call(self, params, inputs, state=None, training=False, rng=None):
        if not training or rng is None:
            return inputs
        return inputs + self.sigma * torch.randn(
            inputs.shape, generator=generator_of(rng), device=inputs.device,
            dtype=inputs.dtype)


class GaussianDropout(Layer):
    """Multiplies by 1 + N(0, p / (1 - p)) noise in training."""

    def __init__(self, p, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.p = float(p)

    def call(self, params, inputs, state=None, training=False, rng=None):
        if not training or rng is None or self.p <= 0:
            return inputs
        std = float(np.sqrt(self.p / (1.0 - self.p)))
        return inputs * (1.0 + std * torch.randn(
            inputs.shape, generator=generator_of(rng), device=inputs.device,
            dtype=inputs.dtype))


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


class Masking(Layer):
    """Zeroes the timesteps (last-axis vectors) that equal ``mask_value``
    everywhere: masking by value, the shape unchanged."""

    def __init__(self, mask_value=0.0, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.mask_value = float(mask_value)

    def call(self, params, inputs, state=None, training=False, rng=None):
        keep = torch.any(inputs != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, inputs, 0.0)


class Highway(Layer):
    """``y = t * act(x W_h + b) + (1 - t) * x``, ``t = sigmoid(x W_t +
    b_t)``; the gate bias starts at -1 (near the identity)."""

    def __init__(self, activation="tanh", bias=True, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.activation = get_activation(activation)
        self.bias = bias

    def build(self, input_shape):
        d = int(input_shape[-1])
        self.add_weight("kernel", (d, d))
        self.add_weight("gate_kernel", (d, d))
        if self.bias:
            self.add_weight("bias", (d,), "zero")
            self.add_weight("gate_bias", (d,), -1.0)

    def call(self, params, inputs, state=None, training=False, rng=None):
        h = inputs @ params["kernel"]
        t = inputs @ params["gate_kernel"]
        if self.bias:
            h = h + params["bias"]
            t = t + params["gate_bias"]
        t = torch.sigmoid(t)
        return t * self.activation(h) + (1.0 - t) * inputs


class Select(Layer):
    """Index ``index`` along ``dim`` (0-based, the batch included), that
    dim dropped."""

    def __init__(self, dim, index, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dim = int(dim)
        self.index = int(index)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.select(inputs, self.dim, self.index)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        dim = self.dim if self.dim >= 0 else len(shape) + self.dim
        del shape[dim]
        return tuple(shape)


class MaxoutDense(Layer):
    """``y_j = max_k (x W_k + b_k)_j`` over ``nb_feature`` maps, one
    (in, nb_feature · out) matmul."""

    def __init__(self, output_dim, nb_feature=4, bias=True,
                 init="glorot_uniform", input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.bias = bias
        self.init = init
        self._config = dict(output_dim=output_dim, nb_feature=nb_feature)

    def build(self, input_shape):
        in_dim = int(input_shape[-1])
        self.add_weight("kernel", (in_dim, self.nb_feature * self.output_dim),
                        self.init)
        if self.bias:
            self.add_weight("bias", (self.nb_feature * self.output_dim,),
                            "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        y = inputs @ params["kernel"]
        if self.bias:
            y = y + params["bias"]
        y = y.reshape(y.shape[:-1] + (self.nb_feature, self.output_dim))
        return torch.amax(y, dim=-2)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class SparseDense(Layer):
    """Dense over a dense input or a COO triple ``(indices, values,
    dense_shape)``: ``indices`` (nnz, 2) rows of (sample, feature),
    ``dense_shape`` static ints.  ``backward_start`` / ``backward_length``
    (1-based, -1 to disable) keep the gradient to the input features in
    their window only."""

    def __init__(self, output_dim, activation=None, bias=True,
                 init="glorot_uniform", backward_start=-1, backward_length=-1,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.output_dim = int(output_dim)
        self.activation = get_activation(activation)
        self.bias = bias
        self.init = init
        self.backward_start = int(backward_start)
        self.backward_length = int(backward_length)
        if self.backward_start != -1 and self.backward_start < 1:
            raise ValueError(
                "backward_start is 1-based (like the reference "
                "SparseLinear): use -1 to disable or a value >= 1, got "
                f"{backward_start}")
        self._config = dict(output_dim=output_dim, bias=bias,
                            backward_start=backward_start,
                            backward_length=backward_length)

    def _grad_window(self, n_features):
        if self.backward_start < 0:
            return None
        start = self.backward_start - 1
        length = (self.backward_length if self.backward_length >= 0
                  else n_features - start)
        return start, start + length

    def build(self, input_shape):
        in_dim = int(input_shape[-1])
        self.add_weight("kernel", (in_dim, self.output_dim), self.init)
        if self.bias:
            self.add_weight("bias", (self.output_dim,), "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        kernel = params["kernel"]
        if isinstance(inputs, (tuple, list)) and len(inputs) == 3:
            indices, values, dense_shape = inputs
            n, n_feat = int(dense_shape[0]), int(dense_shape[1])
            window = self._grad_window(n_feat)
            if window is not None:
                lo, hi = window
                in_win = (indices[:, 1] >= lo) & (indices[:, 1] < hi)
                values = torch.where(in_win, values, values.detach())
            contrib = values[:, None] * kernel[indices[:, 1]]
            y = contrib.new_zeros((n, self.output_dim)).index_add(
                0, indices[:, 0], contrib)
        else:
            window = self._grad_window(inputs.shape[-1])
            if window is not None:
                lo, hi = window
                mask = inputs.new_zeros(inputs.shape[-1])
                mask[lo:hi] = 1.0
                frozen = inputs.detach()
                inputs = frozen + (inputs - frozen) * mask
            y = inputs @ kernel
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)
