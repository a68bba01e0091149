"""Keras-2-style layer API.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras2/layers``: a
20-layer API variant that renames Keras-1 arguments to their Keras-2 forms
(``filters``/``kernel_size``/``strides``/``padding``, ``units``, ``rate``,
``use_bias``, ``kernel_initializer``) and adds the functional merge layers
Maximum/Minimum/Average.

Each class here is a thin adapter over the port's Keras-1 implementation in
:mod:`analytics_zoo_tpu_torch.pipeline.api.keras.layers`: the same math
and parameter trees, a new surface.  The reference's refusals are kept:
channels-last only (the activations are NHWC and the kernels HWIO, as in
the JAX package), and a zero bias initializer only (the Keras-1 layers
zero-init their bias).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras import layers as k1


def _check_channels_last(data_format):
    if data_format not in (None, "channels_last"):
        raise ValueError(
            "the port is channels-last only (NHWC), as the JAX package; got "
            f"data_format={data_format!r}"
        )


def _check_zero_bias(bias_initializer, use_bias=True):
    if not use_bias:
        return  # no bias exists; any initializer is vacuously fine
    if bias_initializer is None:
        return
    name = (bias_initializer if isinstance(bias_initializer, str)
            else type(bias_initializer).__name__)
    if name.lower() not in ("zero", "zeros"):
        raise ValueError(
            "only zero bias initialization is supported (the keras-1 "
            f"implementation zero-inits bias); got {bias_initializer!r}"
        )


class Dense(k1.Dense):
    """keras2 Dense: ``units``/``use_bias``/``kernel_initializer``
    (reference keras2/layers/Dense.scala)."""

    def __init__(self, units, activation=None, use_bias=True,
                 kernel_initializer="glorot_uniform",
                 bias_initializer="zero", input_shape=None, name=None,
                 **kwargs):
        _check_zero_bias(bias_initializer, use_bias)
        super().__init__(units, init=kernel_initializer,
                         activation=activation, bias=use_bias,
                         input_shape=input_shape, name=name, **kwargs)


class Activation(k1.Activation):
    """keras2 Activation (reference keras2/layers/Activation.scala)."""


class Dropout(k1.Dropout):
    """keras2 Dropout: ``rate`` (reference keras2/layers/Dropout.scala)."""

    def __init__(self, rate, input_shape=None, name=None, **kwargs):
        super().__init__(rate, input_shape=input_shape, name=name, **kwargs)


class Flatten(k1.Flatten):
    """keras2 Flatten (reference keras2/layers/Flatten.scala)."""

    def __init__(self, data_format=None, input_shape=None, name=None,
                 **kwargs):
        _check_channels_last(data_format)
        super().__init__(input_shape=input_shape, name=name, **kwargs)


class Conv1D(k1.Convolution1D):
    """keras2 Conv1D: ``filters``/``kernel_size``/``strides``/``padding``
    (reference keras2/layers/Conv1D.scala)."""

    def __init__(self, filters, kernel_size, strides=1, padding="valid",
                 activation=None, use_bias=True,
                 kernel_initializer="glorot_uniform",
                 bias_initializer="zero", input_shape=None, name=None,
                 **kwargs):
        _check_zero_bias(bias_initializer, use_bias)
        super().__init__(filters, kernel_size, subsample_length=strides,
                         border_mode=padding, activation=activation,
                         bias=use_bias, init=kernel_initializer,
                         input_shape=input_shape, name=name, **kwargs)


class Conv2D(k1.Convolution2D):
    """keras2 Conv2D (reference keras2/layers/Conv2D.scala).  NHWC only."""

    def __init__(self, filters, kernel_size, strides=(1, 1),
                 padding="valid", data_format=None, activation=None,
                 use_bias=True, kernel_initializer="glorot_uniform",
                 bias_initializer="zero", input_shape=None, name=None,
                 **kwargs):
        _check_channels_last(data_format)
        _check_zero_bias(bias_initializer, use_bias)
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        super().__init__(filters, kernel_size[0], kernel_size[1],
                         subsample=strides, border_mode=padding,
                         activation=activation, bias=use_bias,
                         init=kernel_initializer, input_shape=input_shape,
                         name=name, **kwargs)


class Cropping1D(k1.Cropping1D):
    """keras2 Cropping1D (reference keras2/layers/Cropping1D.scala)."""


class LocallyConnected1D(k1.LocallyConnected1D):
    """keras2 LocallyConnected1D (reference
    keras2/layers/LocallyConnected1D.scala)."""

    def __init__(self, filters, kernel_size, strides=1, activation=None,
                 use_bias=True, kernel_initializer="glorot_uniform",
                 input_shape=None, name=None, **kwargs):
        super().__init__(filters, kernel_size, subsample_length=strides,
                         activation=activation, bias=use_bias,
                         init=kernel_initializer, input_shape=input_shape,
                         name=name, **kwargs)


class MaxPooling1D(k1.MaxPooling1D):
    """keras2 MaxPooling1D: ``pool_size``/``strides``/``padding``
    (reference keras2/layers/MaxPooling1D.scala)."""

    def __init__(self, pool_size=2, strides=None, padding="valid",
                 input_shape=None, name=None, **kwargs):
        super().__init__(pool_length=pool_size, stride=strides,
                         border_mode=padding, input_shape=input_shape,
                         name=name, **kwargs)


class AveragePooling1D(k1.AveragePooling1D):
    """keras2 AveragePooling1D (reference
    keras2/layers/AveragePooling1D.scala)."""

    def __init__(self, pool_size=2, strides=None, padding="valid",
                 input_shape=None, name=None, **kwargs):
        super().__init__(pool_length=pool_size, stride=strides,
                         border_mode=padding, input_shape=input_shape,
                         name=name, **kwargs)


def _global_pool(base):
    class _G(base):
        def __init__(self, data_format=None, input_shape=None, name=None,
                     **kwargs):
            _check_channels_last(data_format)
            super().__init__(input_shape=input_shape, name=name, **kwargs)

    # both names must point at the module-level alias or pickle (used by
    # KerasNet.save) cannot resolve the factory-local class
    _G.__name__ = base.__name__
    _G.__qualname__ = base.__name__
    return _G


GlobalAveragePooling1D = _global_pool(k1.GlobalAveragePooling1D)
GlobalAveragePooling2D = _global_pool(k1.GlobalAveragePooling2D)
GlobalAveragePooling3D = _global_pool(k1.GlobalAveragePooling3D)
GlobalMaxPooling1D = _global_pool(k1.GlobalMaxPooling1D)
GlobalMaxPooling2D = _global_pool(k1.GlobalMaxPooling2D)
GlobalMaxPooling3D = _global_pool(k1.GlobalMaxPooling3D)


class Softmax(k1.Softmax):
    """keras2 Softmax layer (reference keras2/layers/Softmax.scala)."""


class _FunctionalMerge(k1.Merge):
    """Maximum/Minimum/Average (reference keras2/layers/{Maximum,Minimum,
    Average}.scala): element-wise merges of a list of same-shape inputs."""

    _mode = "max"

    def __init__(self, input_shape=None, name=None, **kwargs):
        super().__init__(mode=self._mode, input_shape=input_shape,
                         name=name, **kwargs)


class Maximum(_FunctionalMerge):
    _mode = "max"


class Minimum(_FunctionalMerge):
    _mode = "min"


class Average(_FunctionalMerge):
    _mode = "ave"


def maximum(inputs, **kwargs):
    """Functional form (reference keras2 merge helpers)."""
    return Maximum(**kwargs)(inputs)


def minimum(inputs, **kwargs):
    return Minimum(**kwargs)(inputs)


def average(inputs, **kwargs):
    return Average(**kwargs)(inputs)
