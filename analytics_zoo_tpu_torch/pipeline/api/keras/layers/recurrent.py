"""Recurrent layers: SimpleRNN, LSTM, GRU, Bidirectional, TimeDistributed,
ConvLSTM2D and ConvLSTM3D.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/recurrent.py``
with its trees and gates: one fused kernel (in, g·units), recurrent kernel
(units, g·units) and bias (g·units) a layer, LSTM's gate order i, f, c, o
and GRU's z, r, h, ``hard_sigmoid`` (``F.hardsigmoid`` = ``jax.nn.
hard_sigmoid``) as the default inner activation, and GRU's candidate
``act(x·W_h + r * (h·U_h) + b_h)`` with one bias.  ``torch.nn.LSTM``/``GRU``
(cuDNN) compute other gates and cannot stand in.

The reference scans the time axis with ``lax.scan``; here the time loop is
a Python loop over T, which a fit's captured step records with the rest of
the step.  The input projection of every timestep is hoisted out of the
loop as one (T·B, F) × (F, g·U) product with the bias added and taken
apart by ``unbind`` (whose backward stacks the T gradients once), and each
step adds ``h @ U`` by one ``addmm``: ``(x·W + b) + h·U`` where the reference
sums ``(x·W + h·U) + b``, a change of rounding order within the tests'
tolerance.  The reference's carry starts as f32 zeros, so its recurrence
runs in f32 whatever the compute dtype; the port's does too and casts the
layer's output back to the input's dtype.

ConvLSTM applies ``border_mode`` and ``subsample`` to the input convolution
only; the recurrent convolution is SAME at stride 1 (XLA's SAME pads, from
``conv.pad_same``).  Its carry takes the input's dtype, as the reference's.
"""

from __future__ import annotations

import copy

import torch

from analytics_zoo_tpu_torch.ops.activations import get_activation
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer, fold_in
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
    _CONV,
    _conv_out_dim,
    channels_first,
    channels_last,
    pad_same,
)


class _RNNBase(Layer):
    units_per_gate = 1  # number of stacked gate blocks in the fused kernel

    def __init__(self, output_dim, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 go_backwards=False, init="glorot_uniform",
                 inner_init="orthogonal", input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.output_dim = int(output_dim)
        self.activation = get_activation(activation)
        self.inner_activation = get_activation(inner_activation)
        self.return_sequences = bool(return_sequences)
        self.go_backwards = bool(go_backwards)
        self.init = init
        self.inner_init = inner_init
        self._config = dict(output_dim=output_dim,
                            return_sequences=return_sequences)

    def build(self, input_shape):
        in_dim = int(input_shape[-1])
        g = self.units_per_gate
        self.add_weight("kernel", (in_dim, g * self.output_dim), self.init)
        self.add_weight("recurrent_kernel",
                        (self.output_dim, g * self.output_dim),
                        self.inner_init)
        self.add_weight("bias", (g * self.output_dim,), "zero")

    def initial_carry(self, batch, like):
        return torch.zeros((batch, self.output_dim), dtype=like.dtype,
                           device=like.device)

    def step(self, carry, xw_t, rk):
        """(new carry, output) of one timestep: ``xw_t`` is x_t·W + b."""
        raise NotImplementedError

    def call(self, params, inputs, state=None, training=False, rng=None):
        b, t = inputs.shape[0], inputs.shape[1]
        dtype = torch.promote_types(inputs.dtype, torch.float32)
        x = inputs.transpose(0, 1)  # (T, B, F)
        if self.go_backwards:
            x = x.flip(0)
        xw = (x.reshape(t * b, -1) @ params["kernel"]).to(dtype) \
            + params["bias"].to(dtype)
        rk = params["recurrent_kernel"].to(dtype)
        carry = self.initial_carry(b, xw)
        outs = []
        # unbind, not xw[i]: its backward stacks the T slices' gradients
        # once, where indexing's would write each into a zero tensor of
        # xw's whole size and add that up, T times
        for xw_t in xw.reshape(t, b, -1).unbind(0):
            carry, out = self.step(carry, xw_t, rk)
            if self.return_sequences:
                outs.append(out)
        if self.return_sequences:
            y = torch.stack(outs, 1)
            if self.go_backwards:
                y = y.flip(1)
        else:
            y = self._final_output(carry)
        return y.to(inputs.dtype)

    def _final_output(self, carry):
        return carry

    def compute_output_shape(self, input_shape):
        if self.return_sequences:
            return (input_shape[0], input_shape[1], self.output_dim)
        return (input_shape[0], self.output_dim)


class SimpleRNN(_RNNBase):
    """``h = act(x·W + h·U + b)``."""

    units_per_gate = 1

    def step(self, carry, xw_t, rk):
        h = self.activation(torch.addmm(xw_t, carry, rk))
        return h, h


class LSTM(_RNNBase):
    """Gate order i, f, c, o in one fused kernel."""

    units_per_gate = 4

    def initial_carry(self, batch, like):
        z = super().initial_carry(batch, like)
        return (z, z)  # (h, c)

    def step(self, carry, xw_t, rk):
        h, c = carry
        i, f, g, o = torch.addmm(xw_t, h, rk).chunk(4, dim=-1)
        i = self.inner_activation(i)
        f = self.inner_activation(f)
        g = self.activation(g)
        o = self.inner_activation(o)
        c = f * c + i * g
        h = o * self.activation(c)
        return (h, c), h

    def _final_output(self, carry):
        return carry[0]


class GRU(_RNNBase):
    """Gate order z, r, h; the candidate is ``act(x·W_h + r * (h·U_h) +
    b_h)``."""

    units_per_gate = 3

    def step(self, carry, xw_t, rk):
        h = carry
        d = self.output_dim
        hz = h @ rk
        z = self.inner_activation(xw_t[:, :d] + hz[:, :d])
        r = self.inner_activation(xw_t[:, d:2 * d] + hz[:, d:2 * d])
        hh = self.activation(xw_t[:, 2 * d:] + r * hz[:, 2 * d:])
        new_h = z * h + (1.0 - z) * hh
        return new_h, new_h


class Bidirectional(Layer):
    """An RNN layer run forward and, as a deep copy with ``go_backwards``
    flipped, backward; the two merged by ``merge_mode`` (concat, sum, mul,
    ave).  Parameters ``{"fwd", "bwd"}``, drawn from ``fold_in(rng, 0)``
    and ``fold_in(rng, 1)``."""

    def __init__(self, layer: _RNNBase, merge_mode="concat",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape or layer._input_shape,
                         name=name, **kwargs)
        if not isinstance(layer, _RNNBase):
            raise TypeError("Bidirectional wraps RNN layers")
        self.forward_layer = layer
        self.backward_layer = copy.deepcopy(layer)
        self.backward_layer.go_backwards = not layer.go_backwards
        self.forward_layer.name = f"{self.name}_fwd"
        self.backward_layer.name = f"{self.name}_bwd"
        self.forward_layer._auto_named = False
        self.backward_layer._auto_named = False
        self.merge_mode = merge_mode

    def build(self, input_shape):
        self.forward_layer.ensure_built(input_shape)
        self.backward_layer.ensure_built(input_shape)

    def init_params(self, rng):
        return {"fwd": self.forward_layer.init_params(fold_in(rng, 0)),
                "bwd": self.backward_layer.init_params(fold_in(rng, 1))}

    def call(self, params, inputs, state=None, training=False, rng=None):
        a = self.forward_layer.call(params["fwd"], inputs,
                                    training=training, rng=rng)
        b = self.backward_layer.call(params["bwd"], inputs,
                                     training=training, rng=rng)
        if self.merge_mode == "concat":
            return torch.cat([a, b], dim=-1)
        if self.merge_mode == "sum":
            return a + b
        if self.merge_mode == "mul":
            return a * b
        if self.merge_mode == "ave":
            return (a + b) / 2.0
        raise ValueError(f"merge_mode {self.merge_mode!r}")

    def compute_output_shape(self, input_shape):
        shape = self.forward_layer.compute_output_shape(input_shape)
        if self.merge_mode == "concat":
            return tuple(shape[:-1]) + (shape[-1] * 2,)
        return shape


class TimeDistributed(Layer):
    """Applies a layer to every timestep by folding time into the batch:
    one batched call, parameters ``{"inner"}`` (and state ``{"inner"}``
    for a stateful inner layer)."""

    def __init__(self, layer: Layer, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape or layer._input_shape,
                         name=name, **kwargs)
        self.inner = layer
        self.inner.name = f"{self.name}_inner"
        self.inner._auto_named = False

    def build(self, input_shape):
        self.inner.ensure_built(tuple(input_shape[1:]))

    def init_params(self, rng):
        return {"inner": self.inner.init_params(rng)}

    def init_state(self):
        s = self.inner.init_state()
        return {"inner": s} if s else {}

    @property
    def stateful(self):
        return self.inner.stateful

    def call(self, params, inputs, state=None, training=False, rng=None):
        b, t = inputs.shape[0], inputs.shape[1]
        flat = inputs.reshape((b * t,) + tuple(inputs.shape[2:]))
        out, new_state = self.inner.apply(
            params["inner"], flat, state=(state or {}).get("inner"),
            training=training, rng=rng)
        out = out.reshape((b, t) + tuple(out.shape[1:]))
        if self.stateful:
            return out, {"inner": new_state}
        return out

    def compute_output_shape(self, input_shape):
        inner_shape = self.inner.compute_output_shape(
            (input_shape[0],) + tuple(input_shape[2:]))
        return (input_shape[0], input_shape[1]) + tuple(inner_shape[1:])


class _ConvLSTMND(Layer):
    """Rank-parameterized convolutional LSTM over channels-last frames
    (B, T, *spatial, C): the four gates one convolution, i, f, c, o."""

    rank: int = 2

    def __init__(self, nb_filter, nb_kernel, return_sequences=False,
                 border_mode="same", subsample=None,
                 inner_activation="hard_sigmoid", activation="tanh",
                 go_backwards=False, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.nb_filter = int(nb_filter)
        self.nb_kernel = int(nb_kernel)
        self.return_sequences = return_sequences
        self.border_mode = border_mode
        if subsample is None:
            subsample = (1,) * self.rank
        self.subsample = tuple(
            subsample if isinstance(subsample, (list, tuple))
            else (subsample,) * self.rank)
        self.activation = get_activation(activation)
        self.inner_activation = get_activation(inner_activation)
        self.go_backwards = go_backwards

    def build(self, input_shape):
        # input (without batch): (T, *spatial, C)
        in_ch = int(input_shape[-1])
        k = (self.nb_kernel,) * self.rank
        self.add_weight("kernel", k + (in_ch, 4 * self.nb_filter))
        self.add_weight("recurrent_kernel",
                        k + (self.nb_filter, 4 * self.nb_filter))
        self.add_weight("bias", (4 * self.nb_filter,), "zero")

    def _out_spatial(self, spatial):
        return tuple(_conv_out_dim(s, self.nb_kernel, st, self.border_mode)
                     for s, st in zip(spatial, self.subsample))

    def _conv(self, x, w, strides, mode):
        r = self.rank
        xf = channels_first(x)
        if mode == "same":
            xf = pad_same(xf, tuple(w.shape[:r]), strides)
        wf = w.permute(r + 1, r, *range(r))  # (out, in, ..spatial..)
        return channels_last(_CONV[r](xf, wf, stride=strides))

    def call(self, params, inputs, state=None, training=False, rng=None):
        b, t = inputs.shape[0], inputs.shape[1]
        frames = inputs.transpose(0, 1)
        if self.go_backwards:
            frames = frames.flip(0)
        # every timestep's input convolution at once, bias added
        xc = self._conv(frames.reshape((t * b,) + tuple(inputs.shape[2:])),
                        params["kernel"], self.subsample,
                        self.border_mode) + params["bias"]
        xc = xc.reshape((t, b) + tuple(xc.shape[1:]))
        h = torch.zeros(tuple(xc.shape[1:-1]) + (self.nb_filter,),
                        dtype=inputs.dtype, device=inputs.device)
        c = torch.zeros_like(h)
        ones = (1,) * self.rank
        outs = []
        for xc_t in xc.unbind(0):  # one stacked gradient, as in _RNNBase
            z = xc_t + self._conv(h, params["recurrent_kernel"], ones,
                                  "same")
            gi, gf, gg, go = z.chunk(4, dim=-1)
            gi = self.inner_activation(gi)
            gf = self.inner_activation(gf)
            gg = self.activation(gg)
            go = self.inner_activation(go)
            c = gf * c + gi * gg
            h = go * self.activation(c)
            if self.return_sequences:
                outs.append(h)
        if self.return_sequences:
            y = torch.stack(outs, 1)
            return y.flip(1) if self.go_backwards else y
        return h

    def compute_output_shape(self, input_shape):
        b, t = input_shape[:2]
        out_spatial = self._out_spatial(input_shape[2:2 + self.rank])
        if self.return_sequences:
            return (b, t) + out_spatial + (self.nb_filter,)
        return (b,) + out_spatial + (self.nb_filter,)


class ConvLSTM2D(_ConvLSTMND):
    """Convolutional LSTM over NHWC frames."""
    rank = 2


class ConvLSTM3D(_ConvLSTMND):
    """Volumetric convolutional LSTM over NDHWC volumes."""
    rank = 3
