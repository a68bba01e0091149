"""Merge: combine a list of inputs by sum, mul, max, min, ave, concat,
dot or cosine.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/merge.py``.
"""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


def _fold(xs, op):
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x)
    return out


def _unit(a):
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True),
                           min=1e-7)


class Merge(Layer):
    """Modes sum, mul, max, min, ave, concat, dot, cosine."""

    def __init__(self, layers=None, mode="sum", concat_axis=-1,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.mode = mode
        self.concat_axis = concat_axis
        self._config = dict(mode=mode, concat_axis=concat_axis)

    def call(self, params, inputs, state=None, training=False, rng=None):
        xs = list(inputs)
        m = self.mode
        if m == "sum":
            return _fold(xs, torch.add)
        if m == "mul":
            return _fold(xs, torch.mul)
        if m == "max":
            return _fold(xs, torch.maximum)
        if m == "min":
            return _fold(xs, torch.minimum)
        if m == "ave":
            return _fold(xs, torch.add) / len(xs)
        if m == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        if m == "dot":
            a, b = xs
            return torch.sum(a * b, dim=-1, keepdim=True)
        if m == "cosine":
            a, b = xs
            return torch.sum(_unit(a) * _unit(b), dim=-1, keepdim=True)
        raise ValueError(f"unknown merge mode {self.mode!r}")

    def compute_output_shape(self, input_shapes):
        shapes = list(input_shapes)
        if self.mode in ("sum", "mul", "max", "min", "ave"):
            return shapes[0]
        if self.mode == "concat":
            base = list(shapes[0])
            ax = self.concat_axis
            if ax < 0:
                ax += len(base)
            total = 0
            for s in shapes:
                if s[ax] is None:
                    total = None
                    break
                total += s[ax]
            base[ax] = total
            return tuple(base)
        if self.mode in ("dot", "cosine"):
            return (shapes[0][0], 1)
        raise ValueError(self.mode)
