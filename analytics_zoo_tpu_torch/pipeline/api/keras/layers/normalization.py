"""Normalization layers: BatchNormalization and LayerNormalization.

Counterpart of
``analytics_zoo_tpu/pipeline/api/keras/layers/normalization.py``, with its
numerics.  BatchNormalization normalises over every axis but the last
(channels-last), with the batch statistics in f32 whatever the compute
dtype: the biased variance, both to normalise and for ``moving_var``, and
``moving = m·old + (1 − m)·batch`` (momentum 0.99, epsilon 1e-3).  The
statistics fold with gamma and beta into one per-channel scale and offset,
and the output keeps the input's dtype.  The moving statistics are the
layer's state (``add_state``), returned as ``(y, new_state)``; evaluation
normalises with them.  ``F.batch_norm`` is not used: it updates its
running variance with the unbiased variance and takes 1 − m as its
momentum.  ``recalibrate_batchnorm`` sets a model's moving statistics to
one batch's (a served model whose training left them near their initial
values).  ``WithinChannelLRN2D`` waits for its slice (ROADMAP queue 1,
item 3).
"""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


class BatchNormalization(Layer):
    """Channels-last batch norm over all non-channel axes."""

    def __init__(self, epsilon=1e-3, momentum=0.99, beta_init="zero",
                 gamma_init="one", scale=True, center=True,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.scale = scale
        self.center = center
        self.beta_init = beta_init
        self.gamma_init = gamma_init
        self._config = dict(epsilon=epsilon, momentum=momentum)

    def build(self, input_shape):
        ch = int(input_shape[-1])
        if self.scale:
            self.add_weight("gamma", (ch,), self.gamma_init)
        if self.center:
            self.add_weight("beta", (ch,), self.beta_init)
        self.add_state("moving_mean", (ch,), "zero")
        self.add_state("moving_var", (ch,), "one")

    def call(self, params, inputs, state=None, training=False, rng=None):
        if not state:
            state = {k: v.to(inputs.device)
                     for k, v in self.init_state().items()}
        if training:
            axes = tuple(range(inputs.dim() - 1))
            var, mean = torch.var_mean(inputs.float(), dim=axes,
                                       correction=0)
            m = self.momentum
            new_state = {
                "moving_mean": m * state["moving_mean"].float()
                + (1 - m) * mean,
                "moving_var": m * state["moving_var"].float()
                + (1 - m) * var,
            }
        else:
            mean = state["moving_mean"].float()
            var = state["moving_var"].float()
            new_state = state
        inv = torch.reciprocal(torch.sqrt(var + self.epsilon))
        scale = inv
        if self.scale:
            scale = scale * params["gamma"].float()
        offset = -mean * scale
        if self.center:
            offset = offset + params["beta"].float()
        y = inputs * scale.to(inputs.dtype) + offset.to(inputs.dtype)
        return y, new_state

    @property
    def stateful(self):
        return True


def recalibrate_batchnorm(net, x) -> None:
    """Set the moving statistics of ``net`` (a built model) to those of the
    batch ``x``: one training-mode forward from zero moving statistics,
    after which each layer's new statistics are its ``1 - momentum`` times
    the batch's.  No layer is changed; ``net.state`` is replaced."""
    bns = {ly.name: ly for ly in net.layers
           if isinstance(ly, BatchNormalization)}
    if any(ly.momentum >= 1.0 for ly in bns.values()):
        raise ValueError("a BatchNormalization with momentum 1 keeps its "
                         "moving statistics; it cannot be recalibrated")
    zero = {k: ({n: torch.zeros_like(v) for n, v in s.items()}
                if k in bns else s) for k, s in net.state.items()}
    with torch.no_grad():
        _, new = net.forward(net.params, torch.as_tensor(x, device=net.device),
                             state=zero, training=True)
    net.state = {k: ({n: v / (1.0 - bns[k].momentum) for n, v in s.items()}
                     if k in bns else net.state[k]) for k, s in new.items()}


class LayerNormalization(Layer):
    """Layer norm over the last axis: statistics in f32, the normalise in
    the compute dtype."""

    def __init__(self, epsilon=1e-5, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.epsilon = float(epsilon)

    def build(self, input_shape):
        d = int(input_shape[-1])
        self.add_weight("gamma", (d,), "one")
        self.add_weight("beta", (d,), "zero")

    def call(self, params, inputs, state=None, training=False, rng=None):
        var, mean = torch.var_mean(inputs.float(), dim=-1, keepdim=True,
                                   correction=0)
        inv = torch.reciprocal(torch.sqrt(var + self.epsilon))
        y = (inputs - mean.to(inputs.dtype)) * inv.to(inputs.dtype)
        return y * params["gamma"] + params["beta"]
