"""Advanced activation layers: LeakyReLU, ELU, ThresholdedReLU, PReLU,
ParametricSoftPlus and SReLU.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/advanced.py``
with its boundaries (``>=`` 0 for the leaky and exponential branches,
``>`` theta for ThresholdedReLU, strict ``<``/``>`` at SReLU's two
thresholds) and its initial values, so a parameter tree carries over leaf
for leaf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


class LeakyReLU(Layer):
    def __init__(self, alpha=0.3, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.alpha = float(alpha)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.where(inputs >= 0, inputs, self.alpha * inputs)


class ELU(Layer):
    def __init__(self, alpha=1.0, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.alpha = float(alpha)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.where(inputs >= 0, inputs,
                           self.alpha * torch.expm1(inputs))


class ThresholdedReLU(Layer):
    def __init__(self, theta=1.0, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.theta = float(theta)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.where(inputs > self.theta, inputs, 0.0)


class PReLU(Layer):
    """Per-channel learnable leak, initialised to 0.25."""

    def build(self, input_shape):
        self.add_weight("alpha", (int(input_shape[-1]),), 0.25)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return torch.where(inputs >= 0, inputs, params["alpha"] * inputs)


class ParametricSoftPlus(Layer):
    """``alpha * softplus(beta * x)`` with learnable per-channel alpha and
    beta."""

    def __init__(self, alpha_init=0.2, beta_init=5.0, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.alpha_init = float(alpha_init)
        self.beta_init = float(beta_init)

    def build(self, input_shape):
        ch = int(input_shape[-1])
        self.add_weight("alpha", (ch,), self.alpha_init)
        self.add_weight("beta", (ch,), self.beta_init)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return params["alpha"] * F.softplus(params["beta"] * inputs)


class SReLU(Layer):
    """S-shaped ReLU with four learnable per-channel parameters: linear
    with slope ``a_left`` below ``t_left``, with slope ``a_right`` above
    ``t_right``, the identity between."""

    def build(self, input_shape):
        ch = int(input_shape[-1])
        self.add_weight("t_left", (ch,), "zero")
        self.add_weight("a_left", (ch,), "glorot_uniform")
        self.add_weight("t_right", (ch,), "glorot_uniform")
        self.add_weight("a_right", (ch,), "one")

    def call(self, params, inputs, state=None, training=False, rng=None):
        tl, al = params["t_left"], params["a_left"]
        tr, ar = params["t_right"], params["a_right"]
        y_left = tl + al * (inputs - tl)
        y_right = tr + ar * (inputs - tr)
        return torch.where(inputs < tl, y_left,
                           torch.where(inputs > tr, y_right, inputs))
