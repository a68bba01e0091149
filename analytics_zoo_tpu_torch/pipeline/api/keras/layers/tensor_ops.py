"""Tensor-manipulation and scalar-op layers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/tensor_ops.py``,
every class of it: the elementwise and thresholding layers, the learnable
per-element ones (CAdd, CMul, Scale, Mul, their weights in the parameter
tree), the sampler, the shape and table ops, LRN2D, ResizeBilinear and
SpaceToDepth.  Axis arguments count the batch axis (dim 0 = batch), as in
the reference.

``LRN2D`` sums the squares over the channel window ``[i - (n-1)//2, i +
n//2]``, Caffe's convention, on the NHWC activation; ``F.local_response_norm``
is channels-first and places an even window the other way, so it is not
used.  ``ResizeBilinear`` gathers as the reference does, with TF1's
coordinates: ``src = dst · in / out`` without ``align_corners`` (not
``F.interpolate``'s half-pixel centres), and ``(in - 1) / (out - 1)`` with
it, falling back to the former on an axis of length 1.  The random layers
(RReLU, GaussianSampler) draw from ``rng`` as ``Dropout`` does
(``layers/core.py``): equal to the reference in distribution, not bit for
bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.engine import generator_of
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


# ---------------------------------------------------------------------------
# scalar / elementwise math
# ---------------------------------------------------------------------------

class AddConstant(Layer):
    """y = x + constant."""

    def __init__(self, constant_scalar, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.constant = float(constant_scalar)
        self._config = dict(constant_scalar=self.constant)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs + self.constant


class MulConstant(Layer):
    """y = x * constant."""

    def __init__(self, constant_scalar, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.constant = float(constant_scalar)
        self._config = dict(constant_scalar=self.constant)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs * self.constant


class Negative(Layer):
    """y = -x."""

    def call(self, params, inputs, state=None, training=False, rng=None):
        return -inputs


class Power(Layer):
    """y = (shift + scale * x) ** power."""

    def __init__(self, power, scale=1.0, shift=0.0, input_shape=None,
                 name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.power = float(power)
        self.scale = float(scale)
        self.shift = float(shift)
        self._config = dict(power=power, scale=scale, shift=shift)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.pow(self.shift + self.scale * inputs, self.power)


class Sqrt(Layer):
    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.sqrt(inputs)


class Square(Layer):
    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.square(inputs)


class Exp(Layer):
    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.exp(inputs)


class Log(Layer):
    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.log(inputs)


# ---------------------------------------------------------------------------
# thresholding activations
# ---------------------------------------------------------------------------

class BinaryThreshold(Layer):
    """1 where x > th else 0."""

    def __init__(self, th=1e-6, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.th = float(th)
        self._config = dict(th=self.th)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return (inputs > self.th).to(inputs.dtype)


class Threshold(Layer):
    """x where x > th else v."""

    def __init__(self, th=1e-6, v=0.0, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.th = float(th)
        self.v = float(v)
        self._config = dict(th=self.th, v=self.v)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.where(inputs > self.th, inputs, self.v)


class HardShrink(Layer):
    """x where |x| > value else 0."""

    def __init__(self, value=0.5, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.value = float(value)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.where(inputs.abs() > self.value, inputs, 0.0)


class SoftShrink(Layer):
    """sign(x) * max(|x| - value, 0)."""

    def __init__(self, value=0.5, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.value = float(value)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.sign(inputs) * torch.clamp(inputs.abs() - self.value,
                                                min=0.0)


class HardTanh(Layer):
    """clip(x, min_value, max_value)."""

    def __init__(self, min_value=-1.0, max_value=1.0, input_shape=None,
                 name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.clamp(inputs, self.min_value, self.max_value)


class RReLU(Layer):
    """Randomized leaky ReLU: in training each element's negative slope is
    drawn from U(lower, upper); at inference it is their mean."""

    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, input_shape=None,
                 name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.lower = float(lower)
        self.upper = float(upper)

    def call(self, params, inputs, state=None, training=False, rng=None):
        if training and rng is not None:
            u = torch.rand(inputs.shape, generator=generator_of(rng),
                           device=inputs.device, dtype=inputs.dtype)
            slope = self.lower + (self.upper - self.lower) * u
        else:
            slope = (self.lower + self.upper) / 2.0
        return torch.where(inputs >= 0, inputs, slope * inputs)


class Softmax(Layer):
    """Softmax over the last axis."""

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.softmax(inputs, dim=-1)


# ---------------------------------------------------------------------------
# learnable per-element ops
# ---------------------------------------------------------------------------

class CAdd(Layer):
    """A learnable bias of shape ``size`` (no batch dim), broadcast."""

    def __init__(self, size, init="zero", input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.size = tuple(int(s) for s in size)
        self.init = init
        self._config = dict(size=self.size)

    def build(self, input_shape):
        self.add_weight("bias", self.size, self.init)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs + params["bias"]


class CMul(Layer):
    """A learnable scale of shape ``size``, broadcast."""

    def __init__(self, size, init="one", input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.size = tuple(int(s) for s in size)
        self.init = init
        self._config = dict(size=self.size)

    def build(self, input_shape):
        self.add_weight("weight", self.size, self.init)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs * params["weight"]


class Scale(Layer):
    """CMul then CAdd, weights of shape ``size`` (Caffe's Scale)."""

    def __init__(self, size, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.size = tuple(int(s) for s in size)
        self._config = dict(size=self.size)

    def build(self, input_shape):
        self.add_weight("weight", self.size, "one")
        self.add_weight("bias", self.size, "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs * params["weight"] + params["bias"]


class Mul(Layer):
    """One learnable scalar multiplier."""

    def build(self, input_shape):
        self.add_weight("weight", (1,), "uniform")

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs * params["weight"]


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

class GaussianSampler(Layer):
    """The VAE sampler: inputs ``[mean, log_variance]``; in training
    ``mean + eps * exp(log_var / 2)`` with eps ~ N(0, 1), else the mean."""

    def call(self, params, inputs, state=None, training=False, rng=None):
        mean, log_var = inputs
        if not training or rng is None:
            return mean
        eps = torch.randn(mean.shape, generator=generator_of(rng),
                          device=mean.device, dtype=mean.dtype)
        return mean + eps * torch.exp(log_var * 0.5)

    def compute_output_shape(self, input_shape):
        return input_shape[0]


# ---------------------------------------------------------------------------
# shape / table ops
# ---------------------------------------------------------------------------

class GetShape(Layer):
    """The input's shape as an int32 tensor."""

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.tensor(tuple(inputs.shape), dtype=torch.int32,
                            device=inputs.device)

    def compute_output_shape(self, input_shape):
        return (len(input_shape),)


class Expand(Layer):
    """Broadcast singleton dims up to ``shape`` (no batch dim)."""

    def __init__(self, shape, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.target = tuple(int(s) for s in shape)
        self._config = dict(shape=self.target)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs.expand((inputs.shape[0],) + self.target)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self.target


class Narrow(Layer):
    """``length`` elements from ``offset`` along ``dim`` (length -1: to
    the end)."""

    def __init__(self, dim, offset, length=1, input_shape=None, name=None,
                 **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.dim = int(dim)
        self.offset = int(offset)
        self.length = int(length)
        self._config = dict(dim=dim, offset=offset, length=length)

    def call(self, params, inputs, state=None, training=False, rng=None):
        n = inputs.shape[self.dim]
        length = self.length if self.length != -1 else n - self.offset
        return inputs.narrow(self.dim, self.offset, length)

    def compute_output_shape(self, input_shape):
        out = list(input_shape)
        n = out[self.dim]
        out[self.dim] = (self.length if self.length != -1
                         else n - self.offset)
        return tuple(out)


class Max(Layer):
    """Max over ``dim``, optionally keeping it."""

    def __init__(self, dim, keep_dim=False, input_shape=None, name=None,
                 **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.dim = int(dim)
        self.keep_dim = bool(keep_dim)
        self._config = dict(dim=dim, keep_dim=keep_dim)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.amax(inputs, dim=self.dim, keepdim=self.keep_dim)

    def compute_output_shape(self, input_shape):
        out = list(input_shape)
        if self.keep_dim:
            out[self.dim] = 1
        else:
            del out[self.dim]
        return tuple(out)


class SelectTable(Layer):
    """The ``index``-th tensor (zero-based) of a list input."""

    def __init__(self, index, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.index = int(index)
        self._config = dict(index=self.index)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs[self.index]

    def compute_output_shape(self, input_shape):
        return input_shape[self.index]


class SplitTensor(Layer):
    """``num_split`` equal tensors along ``dim``, as a list."""

    def __init__(self, dim, num_split, input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.dim = int(dim)
        self.num_split = int(num_split)
        self._config = dict(dim=dim, num_split=num_split)

    def call(self, params, inputs, state=None, training=False, rng=None):
        n = inputs.shape[self.dim]
        if n % self.num_split:
            raise ValueError(f"dim {self.dim} of size {n} does not split "
                             f"into {self.num_split} equal parts")
        return list(torch.split(inputs, n // self.num_split, dim=self.dim))

    def compute_output_shape(self, input_shape):
        out = list(input_shape)
        out[self.dim] = out[self.dim] // self.num_split
        return [tuple(out)] * self.num_split


# ---------------------------------------------------------------------------
# image ops
# ---------------------------------------------------------------------------

class LRN2D(Layer):
    """Across-channel local response normalization of an NHWC input:
    ``x / (k + alpha / n * sum_window x^2) ** beta``, the window of
    channel ``i`` spanning ``[i - (n-1)//2, i + n//2]`` (zero beyond the
    channels)."""

    def __init__(self, alpha=1e-4, k=1.0, beta=0.75, n=5, input_shape=None,
                 name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.alpha = float(alpha)
        self.k = float(k)
        self.beta = float(beta)
        self.n = int(n)
        self._config = dict(alpha=alpha, k=k, beta=beta, n=n)

    def call(self, params, inputs, state=None, training=False, rng=None):
        c = inputs.shape[-1]
        lo = (self.n - 1) // 2
        sq = F.pad(torch.square(inputs), (lo, self.n - 1 - lo))
        window = sq[..., 0:c]
        for i in range(1, self.n):
            window = window + sq[..., i:i + c]
        return inputs / torch.pow(self.k + self.alpha / self.n * window,
                                  self.beta)


class ResizeBilinear(Layer):
    """Bilinear resize of NHWC images to (output_height, output_width),
    with TF1 ``resize_bilinear``'s coordinates (see the module's
    docstring)."""

    def __init__(self, output_height, output_width, align_corners=False,
                 input_shape=None, name=None, **kw):
        super().__init__(input_shape=input_shape, name=name, **kw)
        self.out_h = int(output_height)
        self.out_w = int(output_width)
        self.align_corners = bool(align_corners)
        self._config = dict(output_height=output_height,
                            output_width=output_width,
                            align_corners=self.align_corners)

    def _coords(self, out_n, in_n, device):
        if self.align_corners and out_n > 1:
            return torch.linspace(0.0, in_n - 1.0, out_n, device=device)
        pos = torch.arange(out_n, dtype=torch.float32, device=device)
        return torch.clamp(pos * (in_n / out_n), max=in_n - 1.0)

    def call(self, params, inputs, state=None, training=False, rng=None):
        h, w = inputs.shape[1], inputs.shape[2]
        ys = self._coords(self.out_h, h, inputs.device)
        xs = self._coords(self.out_w, w, inputs.device)
        y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        wy = (ys - y0)[None, :, None, None].to(inputs.dtype)
        wx = (xs - x0)[None, None, :, None].to(inputs.dtype)
        gy0, gy1 = inputs[:, y0], inputs[:, y1]
        top = gy0[:, :, x0] * (1 - wx) + gy0[:, :, x1] * wx
        bot = gy1[:, :, x0] * (1 - wx) + gy1[:, :, x1] * wx
        return top * (1 - wy) + bot * wy

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.out_h, self.out_w, input_shape[3])


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
