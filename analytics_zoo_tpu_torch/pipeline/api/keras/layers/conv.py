"""Convolution layers, channels-last (NWC, NHWC, NDHWC) with kernels
stored (..spatial.., in, out), as in the reference.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/conv.py``
(``_ConvND`` with ``Convolution1D/2D/3D`` and ``AtrousConvolution1D/2D``,
``ZeroPadding*``, ``Cropping*`` and ``UpSampling*``).  The reference
lowers a convolution to ``lax.conv_general_dilated``; here it is
``F.conv{1,2,3}d`` (cuDNN on the card).  The activation is viewed as
channels-first through a permute, which on the card is a channels-last
tensor that cuDNN runs as it is (no copy); the output permuted back is
contiguous channels-last again.  The kernel permuted to (out, in,
..spatial..) has neither layout, so cuDNN may copy it per call.

SAME padding is XLA's: ``total = max((ceil(n/s) - 1)·s + (k - 1)·d + 1 -
n, 0)``, ``total // 2`` before and the odd one after.  PyTorch's
``padding="same"`` refuses stride > 1 and an integer ``padding=`` is
symmetric, so :func:`pad_same` pads explicitly and the convolution (or
the pooling window, ``layers/pooling.py``) then runs VALID.

Depthwise, separable, transposed, locally connected and shared
convolutions wait for their slice (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops.activations import get_activation
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


def _ntuple(x, n):
    if isinstance(x, int):
        return (x,) * n
    t = tuple(int(v) for v in x)
    assert len(t) == n, f"expected {n} values, got {t}"
    return t


def _conv_out_dim(size, k, stride, mode, dilation=1):
    if size is None:
        return None
    eff = (k - 1) * dilation + 1
    out = ((size + stride - 1) // stride if mode == "same"
           else (size - eff) // stride + 1)
    if out <= 0:
        raise ValueError(
            f"spatial dim collapses to {out}: input size {size} is too "
            f"small for kernel {k} (stride {stride}, dilation {dilation}, "
            f"border_mode={mode!r}) — use a larger input or 'same' padding"
        )
    return out


def same_pads(size: int, k: int, stride: int, dilation: int = 1):
    """(before, after) of XLA's SAME padding for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def pad_same(x, kernel, strides, dilation=None, value=0.0):
    """A channels-first ``x`` (N, C, ..spatial..) padded as XLA's SAME
    padding pads it for windows ``kernel`` at ``strides`` (and
    ``dilation``), with ``value``; unchanged where no dim needs padding."""
    spatial = x.shape[2:]
    dilation = dilation or (1,) * len(spatial)
    pads = [same_pads(int(n), k, s, d)
            for n, k, s, d in zip(spatial, kernel, strides, dilation)]
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # last dim first
    return F.pad(x, flat, value=value)


def channels_first(x):
    """A channels-last tensor viewed as channels-first (no copy)."""
    r = x.dim() - 2
    return x.permute(0, r + 1, *range(1, r + 1))


def channels_last(y):
    """The inverse view of :func:`channels_first`."""
    r = y.dim() - 2
    return y.permute(0, *range(2, r + 2), 1)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class _ConvND(Layer):
    """Shared N-d convolution over the trailing channel axis."""

    rank: int = 2

    def __init__(self, nb_filter, kernel_size, subsample=1,
                 border_mode="valid", activation=None, bias=True,
                 dilation=1, init="glorot_uniform", input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.nb_filter = int(nb_filter)
        self.kernel_size = _ntuple(kernel_size, self.rank)
        self.subsample = _ntuple(subsample, self.rank)
        self.dilation = _ntuple(dilation, self.rank)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode {border_mode!r}")
        self.border_mode = border_mode
        self.activation = get_activation(activation)
        self.bias = bias
        self.init = init
        self._config = dict(nb_filter=nb_filter, kernel_size=self.kernel_size,
                            subsample=self.subsample,
                            border_mode=border_mode, bias=bias)

    def build(self, input_shape):
        in_ch = int(input_shape[-1])
        self.add_weight("kernel",
                        self.kernel_size + (in_ch, self.nb_filter),
                        self.init)
        if self.bias:
            self.add_weight("bias", (self.nb_filter,), "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        r = self.rank
        x = channels_first(inputs)
        if self.border_mode == "same":
            x = pad_same(x, self.kernel_size, self.subsample, self.dilation)
        w = params["kernel"].permute(r + 1, r, *range(r))  # (out, in, ..)
        y = channels_last(_CONV[r](x, w, stride=self.subsample,
                                   dilation=self.dilation))
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        spatial = input_shape[1:-1]
        out_spatial = tuple(
            _conv_out_dim(s, k, st, self.border_mode, d)
            for s, k, st, d in zip(spatial, self.kernel_size,
                                   self.subsample, self.dilation)
        )
        return (input_shape[0],) + out_spatial + (self.nb_filter,)


class Convolution1D(_ConvND):
    """Input (batch, steps, channels)."""
    rank = 1

    def __init__(self, nb_filter, filter_length, subsample_length=1,
                 border_mode="valid", activation=None, bias=True,
                 dilation_rate=1, init="glorot_uniform", input_shape=None,
                 name=None, **kwargs):
        super().__init__(nb_filter, filter_length, subsample_length,
                         border_mode, activation, bias, dilation_rate, init,
                         input_shape, name, **kwargs)


class Convolution2D(_ConvND):
    """Input NHWC."""
    rank = 2

    def __init__(self, nb_filter, nb_row, nb_col=None, subsample=(1, 1),
                 border_mode="valid", activation=None, bias=True,
                 dilation=(1, 1), init="glorot_uniform", input_shape=None,
                 name=None, **kwargs):
        ksize = (nb_row, nb_col) if nb_col is not None else nb_row
        super().__init__(nb_filter, ksize, subsample, border_mode,
                         activation, bias, dilation, init, input_shape, name,
                         **kwargs)


class Convolution3D(_ConvND):
    """Input NDHWC."""
    rank = 3

    def __init__(self, nb_filter, kernel_dim1, kernel_dim2=None,
                 kernel_dim3=None, subsample=(1, 1, 1), border_mode="valid",
                 activation=None, bias=True, init="glorot_uniform",
                 input_shape=None, name=None, **kwargs):
        if kernel_dim2 is None:
            ksize = kernel_dim1
        else:
            ksize = (kernel_dim1, kernel_dim2, kernel_dim3)
        super().__init__(nb_filter, ksize, subsample, border_mode,
                         activation, bias, 1, init, input_shape, name,
                         **kwargs)


class AtrousConvolution1D(Convolution1D):
    """Dilated 1-D convolution."""

    def __init__(self, nb_filter, filter_length, atrous_rate=1, **kwargs):
        super().__init__(nb_filter, filter_length,
                         dilation_rate=atrous_rate, **kwargs)


class AtrousConvolution2D(Convolution2D):
    """Dilated 2-D convolution."""

    def __init__(self, nb_filter, nb_row, nb_col=None, atrous_rate=(1, 1),
                 **kwargs):
        super().__init__(nb_filter, nb_row, nb_col, dilation=atrous_rate,
                         **kwargs)


class _ZeroPaddingND(Layer):
    rank = 2

    def __init__(self, padding, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if isinstance(padding, int):
            padding = ((padding, padding),) * self.rank
        else:
            padding = tuple(
                (p, p) if isinstance(p, int) else tuple(p) for p in padding
            )
        self.padding = padding

    def call(self, params, inputs, state=None, training=False, rng=None):
        flat = [0, 0]  # the channel axis, then the spatial ones last first
        for lo, hi in reversed(self.padding):
            flat += [lo, hi]
        return F.pad(inputs, flat)

    def compute_output_shape(self, input_shape):
        spatial = [
            None if s is None else s + p[0] + p[1]
            for s, p in zip(input_shape[1:-1], self.padding)
        ]
        return (input_shape[0],) + tuple(spatial) + (input_shape[-1],)


class ZeroPadding1D(_ZeroPaddingND):
    rank = 1


class ZeroPadding2D(_ZeroPaddingND):
    rank = 2


class ZeroPadding3D(_ZeroPaddingND):
    rank = 3


class _CroppingND(Layer):
    rank = 2

    def __init__(self, cropping, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.cropping = tuple(
            (c, c) if isinstance(c, int) else tuple(c) for c in cropping
        )

    def call(self, params, inputs, state=None, training=False, rng=None):
        idx = [slice(None)]
        for (lo, hi), size in zip(self.cropping, inputs.shape[1:-1]):
            idx.append(slice(lo, size - hi))
        idx.append(slice(None))
        return inputs[tuple(idx)]

    def compute_output_shape(self, input_shape):
        spatial = [
            None if s is None else s - lo - hi
            for s, (lo, hi) in zip(input_shape[1:-1], self.cropping)
        ]
        return (input_shape[0],) + tuple(spatial) + (input_shape[-1],)


class Cropping1D(_CroppingND):
    rank = 1

    def __init__(self, cropping=(1, 1), **kwargs):
        super().__init__((cropping,), **kwargs)


class Cropping2D(_CroppingND):
    rank = 2


class Cropping3D(_CroppingND):
    rank = 3


class _UpSamplingND(Layer):
    rank = 2

    def __init__(self, size=2, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.size = _ntuple(size, self.rank)

    def call(self, params, inputs, state=None, training=False, rng=None):
        y = inputs
        for ax, rep in enumerate(self.size):
            y = torch.repeat_interleave(y, rep, dim=ax + 1)
        return y

    def compute_output_shape(self, input_shape):
        spatial = [
            None if s is None else s * r
            for s, r in zip(input_shape[1:-1], self.size)
        ]
        return (input_shape[0],) + tuple(spatial) + (input_shape[-1],)


class UpSampling1D(_UpSamplingND):
    rank = 1


class UpSampling2D(_UpSamplingND):
    rank = 2


class UpSampling3D(_UpSamplingND):
    rank = 3
