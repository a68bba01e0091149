"""Pooling layers, channels-last.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/pooling.py``
(the twelve Max/Average/GlobalMax/GlobalAverage 1-D, 2-D and 3-D
classes).  The reference reduces windows with ``lax.reduce_window``; here
a window runs through ``F.max_pool*d`` / ``F.avg_pool*d`` on the
channels-first view of the activation (``layers/conv.py``).

SAME padding is XLA's, asymmetric (``conv.pad_same``): max pooling pads
with -inf, so a padded element never wins a window; average pooling pads
with zeros and divides each window's sum by the count of real elements
in it, the same windows summed over a ones tensor, as the reference does.
VALID average pooling divides by the window's size.  The gradient of a max
pool goes to the first maximum of a window (row-major), as XLA's
``select_and_scatter`` gives it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
    _conv_out_dim,
    _ntuple,
    channels_first,
    channels_last,
    pad_same,
)

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, window, strides):
    """Each window's sum of a channels-first ``x``; a 1-D window runs as
    a 2-D one of height 1 (``avg_pool1d`` has no divisor override)."""
    if len(window) == 1:
        return _window_sum(x[:, :, None], (1,) + window,
                           (1,) + strides)[:, :, 0]
    return _AVG[len(window)](x, window, strides, divisor_override=1)


class _PoolND(Layer):
    rank = 2
    mode = "max"

    def __init__(self, pool_size=2, strides=None, border_mode="valid",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.pool_size = _ntuple(pool_size, self.rank)
        self.strides = _ntuple(strides, self.rank) if strides is not None \
            else self.pool_size
        self.border_mode = border_mode

    def call(self, params, inputs, state=None, training=False, rng=None):
        x = channels_first(inputs)
        same = self.border_mode == "same"
        if self.mode == "max":
            if same:
                x = pad_same(x, self.pool_size, self.strides,
                             value=-math.inf)
            return channels_last(_MAX[self.rank](x, self.pool_size,
                                                 self.strides))
        if same:
            padded = pad_same(x, self.pool_size, self.strides)
            y = _window_sum(padded, self.pool_size, self.strides)
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            counts = _window_sum(pad_same(ones, self.pool_size,
                                          self.strides),
                                 self.pool_size, self.strides)
            y = y / counts
        else:
            y = _window_sum(x, self.pool_size, self.strides) \
                / float(math.prod(self.pool_size))
        return channels_last(y)

    def compute_output_shape(self, input_shape):
        spatial = tuple(
            _conv_out_dim(s, k, st, self.border_mode)
            for s, k, st in zip(input_shape[1:-1], self.pool_size,
                                self.strides)
        )
        return (input_shape[0],) + spatial + (input_shape[-1],)


class MaxPooling1D(_PoolND):
    rank, mode = 1, "max"

    def __init__(self, pool_length=2, stride=None, border_mode="valid",
                 **kwargs):
        super().__init__(pool_length, stride, border_mode, **kwargs)


class MaxPooling2D(_PoolND):
    rank, mode = 2, "max"


class MaxPooling3D(_PoolND):
    rank, mode = 3, "max"


class AveragePooling1D(_PoolND):
    rank, mode = 1, "avg"

    def __init__(self, pool_length=2, stride=None, border_mode="valid",
                 **kwargs):
        super().__init__(pool_length, stride, border_mode, **kwargs)


class AveragePooling2D(_PoolND):
    rank, mode = 2, "avg"


class AveragePooling3D(_PoolND):
    rank, mode = 3, "avg"


class _GlobalPoolND(Layer):
    rank = 2
    mode = "max"

    def call(self, params, inputs, state=None, training=False, rng=None):
        axes = tuple(range(1, 1 + self.rank))
        if self.mode == "max":
            return torch.amax(inputs, dim=axes)
        return torch.mean(inputs, dim=axes)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[-1])


class GlobalMaxPooling1D(_GlobalPoolND):
    rank, mode = 1, "max"


class GlobalMaxPooling2D(_GlobalPoolND):
    rank, mode = 2, "max"


class GlobalMaxPooling3D(_GlobalPoolND):
    rank, mode = 3, "max"


class GlobalAveragePooling1D(_GlobalPoolND):
    rank, mode = 1, "avg"


class GlobalAveragePooling2D(_GlobalPoolND):
    rank, mode = 2, "avg"


class GlobalAveragePooling3D(_GlobalPoolND):
    rank, mode = 3, "avg"
