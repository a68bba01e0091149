"""Convolution layers, channels-last (NWC, NHWC, NDHWC) with kernels
stored (..spatial.., in, out), as in the reference.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/conv.py``,
every class of it: ``_ConvND`` with ``Convolution1D/2D/3D``,
``AtrousConvolution1D/2D`` and ``ShareConvolution2D``, the depthwise,
separable, transposed and locally connected convolutions,
``ZeroPadding*``, ``Cropping*`` and ``UpSampling*``.  The reference
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

The depthwise kernel keeps the reference's (kh, kw, 1, in·dm) and runs
as ``F.conv2d`` with ``groups=in`` on it permuted to (in·dm, 1, kh, kw):
output channel ``o`` reads input channel ``o // dm`` in both packages.
``Deconvolution2D`` is ``lax.conv_transpose`` with ``transpose_kernel=
False``: a convolution with the kernel unflipped over the input dilated
by the strides, padded as ``lax`` pads it (:func:`transpose_pads`).  It
is written as that convolution, not as ``F.conv_transpose2d``, which
flips the kernel and pads SAME otherwise.  The locally connected layers
gather the patches with the reference's index arrays and contract them
with one ``einsum``.
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


def _depthwise(inputs, kernel, subsample, border_mode):
    """The grouped convolution of DepthwiseConvolution2D and
    SeparableConvolution2D: an NHWC ``inputs`` and a (kh, kw, 1, in·dm)
    ``kernel``, ``groups = in``."""
    x = channels_first(inputs)
    ksize = tuple(kernel.shape[:2])
    if border_mode == "same":
        x = pad_same(x, ksize, subsample)
    w = kernel.permute(3, 2, 0, 1)  # (in·dm, 1, kh, kw)
    return channels_last(F.conv2d(x, w, stride=subsample,
                                  groups=inputs.shape[-1]))


class DepthwiseConvolution2D(Layer):
    """Depthwise-only convolution, NHWC, kernel (kh, kw, 1, in·dm): the
    MobileNet block puts BatchNorm and the activation between it and the
    pointwise convolution.  The base of SeparableConvolution2D."""

    def __init__(self, nb_row, nb_col=None, subsample=(1, 1),
                 border_mode="valid", depth_multiplier=1, activation=None,
                 bias=True, init="glorot_uniform", input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode {border_mode!r}")
        self.kernel_size = _ntuple((nb_row, nb_col) if nb_col else nb_row, 2)
        self.subsample = _ntuple(subsample, 2)
        self.border_mode = border_mode
        self.depth_multiplier = int(depth_multiplier)
        self.activation = get_activation(activation)
        self.bias = bias
        self.init = init

    def _add_depthwise_kernel(self, input_shape):
        in_ch = int(input_shape[-1])
        self.add_weight(
            "depthwise_kernel",
            self.kernel_size + (1, in_ch * self.depth_multiplier), self.init)
        return in_ch

    def build(self, input_shape):
        in_ch = self._add_depthwise_kernel(input_shape)
        if self.bias:
            self.add_weight("bias", (in_ch * self.depth_multiplier,), "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        y = _depthwise(inputs, params["depthwise_kernel"], self.subsample,
                       self.border_mode)
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)

    def _spatial_out(self, input_shape):
        return tuple(
            _conv_out_dim(s, k, st, self.border_mode)
            for s, k, st in zip(input_shape[1:-1], self.kernel_size,
                                self.subsample))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._spatial_out(input_shape) + (
            int(input_shape[-1]) * self.depth_multiplier,)


class SeparableConvolution2D(DepthwiseConvolution2D):
    """Depthwise, then a pointwise (1, 1, in·dm, out) convolution, NHWC:
    the pointwise one is a matmul over the channel axis."""

    def __init__(self, nb_filter, nb_row, nb_col=None, **kwargs):
        super().__init__(nb_row, nb_col, **kwargs)
        self.nb_filter = int(nb_filter)

    def build(self, input_shape):
        in_ch = self._add_depthwise_kernel(input_shape)
        self.add_weight(
            "pointwise_kernel",
            (1, 1, in_ch * self.depth_multiplier, self.nb_filter), self.init)
        if self.bias:
            self.add_weight("bias", (self.nb_filter,), "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        y = _depthwise(inputs, params["depthwise_kernel"], self.subsample,
                       self.border_mode)
        y = y @ params["pointwise_kernel"][0, 0]
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._spatial_out(input_shape) + (
            self.nb_filter,)


def transpose_pads(k: int, s: int, mode: str):
    """(before, after) padding of the stride-dilated input for a transposed
    convolution of kernel ``k`` and stride ``s``, as ``lax.conv_transpose``
    pads it for SAME and VALID."""
    if mode == "same":
        total = k + s - 2
        before = k - 1 if s > k - 1 else -(-total // 2)
    else:
        total = k + s - 2 + max(k - s, 0)
        before = k - 1
    return before, total - before


class Deconvolution2D(Layer):
    """Transposed convolution, NHWC, kernel (kh, kw, in, out): the input
    dilated by the strides (zeros between its elements) and padded by
    :func:`transpose_pads`, then a stride-1 convolution with the kernel as
    it is stored (``lax.conv_transpose`` with ``transpose_kernel=False``).
    SAME gives ``size · stride``, VALID ``size · stride + max(k - stride,
    0)``."""

    def __init__(self, nb_filter, nb_row, nb_col=None, subsample=(1, 1),
                 border_mode="valid", activation=None, bias=True,
                 init="glorot_uniform", input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.nb_filter = int(nb_filter)
        self.kernel_size = _ntuple((nb_row, nb_col) if nb_col else nb_row, 2)
        self.subsample = _ntuple(subsample, 2)
        self.border_mode = border_mode
        self.activation = get_activation(activation)
        self.bias = bias
        self.init = init

    def build(self, input_shape):
        in_ch = int(input_shape[-1])
        self.add_weight("kernel", self.kernel_size + (in_ch, self.nb_filter),
                        self.init)
        if self.bias:
            self.add_weight("bias", (self.nb_filter,), "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        x = channels_first(inputs)
        n, c, h, w = x.shape
        (sh, sw), (kh, kw) = self.subsample, self.kernel_size
        (t, b), (l, r) = (transpose_pads(kh, sh, self.border_mode),
                          transpose_pads(kw, sw, self.border_mode))
        dh, dw = (h - 1) * sh + 1, (w - 1) * sw + 1
        grid = x.new_zeros((n, c, t + dh + b, l + dw + r))
        grid[:, :, t:t + dh:sh, l:l + dw:sw] = x
        kernel = params["kernel"].permute(3, 2, 0, 1)  # (out, in, kh, kw)
        y = channels_last(F.conv2d(grid, kernel))
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        out = []
        for s, k, st in zip(input_shape[1:-1], self.kernel_size,
                            self.subsample):
            if s is None:
                out.append(None)
            elif self.border_mode == "same":
                out.append(s * st)
            else:
                out.append(s * st + max(k - st, 0))
        return (input_shape[0],) + tuple(out) + (self.nb_filter,)


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


def _windows(n_out: int, stride: int, k: int, device):
    """(n_out, k) indices of each output position's window."""
    starts = torch.arange(n_out, device=device) * stride
    return starts[:, None] + torch.arange(k, device=device)[None, :]


class LocallyConnected1D(Layer):
    """Unshared 1-D convolution: kernel (out_len, k·in, out), bias
    (out_len, out); the patches gathered, then one ``einsum``."""

    def __init__(self, nb_filter, filter_length, subsample_length=1,
                 activation=None, bias=True, init="glorot_uniform",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.nb_filter = int(nb_filter)
        self.filter_length = int(filter_length)
        self.subsample = int(subsample_length)
        self.activation = get_activation(activation)
        self.bias = bias
        self.init = init

    def _out_len(self, steps):
        return (steps - self.filter_length) // self.subsample + 1

    def build(self, input_shape):
        steps, in_ch = int(input_shape[-2]), int(input_shape[-1])
        out_len = self._out_len(steps)
        self.add_weight(
            "kernel", (out_len, self.filter_length * in_ch, self.nb_filter),
            self.init)
        if self.bias:
            self.add_weight("bias", (out_len, self.nb_filter), "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        b, steps, _ = inputs.shape
        out_len = self._out_len(steps)
        idx = _windows(out_len, self.subsample, self.filter_length,
                       inputs.device)
        patches = inputs[:, idx, :].reshape(b, out_len, -1)
        y = torch.einsum("blk,lko->blo", patches, params["kernel"])
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self._out_len(input_shape[1]),
                self.nb_filter)


class LocallyConnected2D(Layer):
    """Unshared 2-D convolution, NHWC, VALID only: kernel (oh, ow,
    kh·kw·in, out) over patches in (kh, kw, in) order, bias (oh, ow,
    out)."""

    def __init__(self, nb_filter, nb_row, nb_col, subsample=(1, 1),
                 border_mode="valid", activation=None, bias=True,
                 init="glorot_uniform", input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if border_mode != "valid":
            raise ValueError("LocallyConnected2D supports border_mode="
                             "'valid' only (the reference raises for 'same')")
        self.nb_filter = int(nb_filter)
        self.nb_row = int(nb_row)
        self.nb_col = int(nb_col)
        self.subsample = _ntuple(subsample, 2)
        self.activation = get_activation(activation)
        self.bias = bias
        self.init = init

    def _out_hw(self, h, w):
        return ((h - self.nb_row) // self.subsample[0] + 1,
                (w - self.nb_col) // self.subsample[1] + 1)

    def build(self, input_shape):
        h, w, in_ch = (int(s) for s in input_shape[-3:])
        oh, ow = self._out_hw(h, w)
        k = self.nb_row * self.nb_col * in_ch
        self.add_weight("kernel", (oh, ow, k, self.nb_filter), self.init)
        if self.bias:
            self.add_weight("bias", (oh, ow, self.nb_filter), "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        b, h, w, _ = inputs.shape
        oh, ow = self._out_hw(h, w)
        rows = _windows(oh, self.subsample[0], self.nb_row, inputs.device)
        cols = _windows(ow, self.subsample[1], self.nb_col, inputs.device)
        # (B, H, W, C) -> (B, OH, kh, W, C) -> (B, OH, kh, OW, kw, C)
        patches = inputs[:, rows][:, :, :, cols]
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, oh, ow, -1)
        y = torch.einsum("bhwk,hwkf->bhwf", patches, params["kernel"])
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        oh, ow = self._out_hw(input_shape[1], input_shape[2])
        return (input_shape[0], oh, ow, self.nb_filter)


class ShareConvolution2D(_ConvND):
    """A Convolution2D with explicit symmetric padding (``pad_h``,
    ``pad_w``) and ``propagate_back=False`` to stop the gradient to its
    input.  The reference's Scala class shares an im2col buffer between
    replicas; there is no such buffer here, so the convolution is
    Convolution2D's."""

    rank = 2

    def __init__(self, nb_filter, nb_row, nb_col, subsample=(1, 1),
                 pad_h=0, pad_w=0, propagate_back=True, activation=None,
                 bias=True, init="glorot_uniform", input_shape=None,
                 name=None, **kwargs):
        super().__init__(nb_filter, (nb_row, nb_col), subsample, "valid",
                         activation, bias, 1, init, input_shape, name,
                         **kwargs)
        self.pad_h = int(pad_h)
        self.pad_w = int(pad_w)
        self.propagate_back = bool(propagate_back)
        self._config.update(pad_h=self.pad_h, pad_w=self.pad_w,
                            propagate_back=self.propagate_back)

    def call(self, params, inputs, state=None, training=False, rng=None):
        if self.pad_h or self.pad_w:
            inputs = F.pad(inputs, (0, 0, self.pad_w, self.pad_w,
                                    self.pad_h, self.pad_h))
        if not self.propagate_back:
            inputs = inputs.detach()
        return super().call(params, inputs, state=state, training=training,
                            rng=rng)

    def compute_output_shape(self, input_shape):
        b, h, w, _ = input_shape
        padded = (b,
                  None if h is None else h + 2 * self.pad_h,
                  None if w is None else w + 2 * self.pad_w,
                  input_shape[3])
        return super().compute_output_shape(padded)
