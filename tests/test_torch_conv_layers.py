"""The port's convolution, pooling, shape, activation, merge and
space-to-depth layers against the JAX package's.

Each case builds one layer in both packages, gives both the same numpy
parameters and inputs, and holds the port's forward and its autograd
gradients (of the parameters and the inputs, under one seeded cotangent)
against the reference's forward and ``jax.grad``.  Cases: VALID and SAME
padding (XLA's asymmetric SAME: ``pad_same``), strides 1 and 2, odd and
even sizes, dilation, 1-D, 2-D and 3-D, and a max pool whose windows tie
(after a ReLU; the gradient goes to the first maximum of a window, as
XLA's ``select_and_scatter`` sends it).

Tolerance: f32, the largest absolute difference within 1e-5 of the
reference's largest magnitude, for outputs and gradients alike (both
packages sum each window in f32; measured at most ~4e-7).

The conv kernels' initialisers (``glorot_uniform``, the conv layers'
default, and ``he_normal``, ResNet's) draw from other generators in the two
packages, so their samples are compared by distribution on HWIO (and 1-D,
3-D) kernel shapes: the mean within 5 standard errors of 0 and the
standard deviation within 5 of its own standard errors of the fan-based
value, in the port and in the reference alike; the uniform one inside its
limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import same_pads

TOL = 1e-5


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _run(name, args, kwargs, shapes, seed=0, relu=False, grad=True):
    """(forward errors, gradient errors) of layer ``name`` built with
    ``args``/``kwargs`` on inputs of the (batch-first) ``shapes``."""
    jlayer = getattr(jl, name)(*args, **kwargs)
    tlayer = getattr(tl, name)(*args, **kwargs)
    single = len(shapes) == 1
    build = shapes[0][1:] if single else [s[1:] for s in shapes]
    jlayer.ensure_built(build)
    tlayer.ensure_built(build)
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if relu:  # many zeros: windows of equal maxima
        xs = [np.maximum(x, 0.0) for x in xs]
    specs = jlayer.init_params(jax.random.PRNGKey(0))
    params = {k: (0.5 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in specs.items()}
    assert sorted(params) == sorted(
        tlayer.init_params(torch.Generator().manual_seed(0)))

    def jfwd(p, x):
        return jlayer.call(p, x[0] if single else x)

    def tfwd(p, x):
        return tlayer.call(p, x[0] if single else x)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx = [jnp.asarray(x) for x in xs]
    want = np.asarray(jfwd(jp, jx))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = [torch.tensor(x, requires_grad=True) for x in xs]
    got = tfwd(tp, tx)
    errs = [_err(got.detach().numpy(), want)]
    if not grad:
        return errs, []
    cot = rng.normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda p, x: jnp.sum(jfwd(p, x) * cot),
                  argnums=(0, 1))(jp, jx)
    (got * torch.from_numpy(cot)).sum().backward()
    gerrs = [_err(tp[k].grad.numpy(), jg[0][k]) for k in sorted(params)]
    gerrs += [_err(t.grad.numpy(), g) for t, g in zip(tx, jg[1])]
    return errs, gerrs


CONV_CASES = {
    "conv2d_valid_s1": ("Convolution2D", (4, 3, 3), {}, [(2, 8, 8, 3)]),
    "conv2d_valid_s2_odd": ("Convolution2D", (4, 3, 3),
                            {"subsample": (2, 2)}, [(2, 9, 9, 3)]),
    "conv2d_same_s1_odd": ("Convolution2D", (4, 3, 3),
                           {"border_mode": "same"}, [(2, 7, 7, 3)]),
    "conv2d_same_s2_even": ("Convolution2D", (4, 3, 3),
                            {"border_mode": "same", "subsample": (2, 2)},
                            [(2, 8, 8, 3)]),
    "conv2d_same_s2_odd": ("Convolution2D", (4, 3, 3),
                           {"border_mode": "same", "subsample": (2, 2)},
                           [(2, 9, 9, 3)]),
    # ResNet's stem geometry: 7x7/s2 SAME on an even size pads (2, 3)
    "conv2d_stem_7x7_s2": ("Convolution2D", (8, 7, 7),
                           {"border_mode": "same", "subsample": (2, 2),
                            "bias": False}, [(2, 16, 16, 3)]),
    "conv2d_same_1x1_s2": ("Convolution2D", (8, 1, 1),
                           {"border_mode": "same", "subsample": (2, 2)},
                           [(2, 8, 8, 4)]),
    "conv2d_rect_tanh": ("Convolution2D", (5, 3, 2),
                         {"border_mode": "same", "activation": "tanh"},
                         [(2, 6, 5, 2)]),
    "conv2d_dilated_same": ("Convolution2D", (4, 3, 3),
                            {"border_mode": "same", "dilation": (2, 2)},
                            [(2, 9, 8, 3)]),
    "atrous2d_valid": ("AtrousConvolution2D", (4, 3, 3),
                       {"atrous_rate": (2, 1)}, [(2, 9, 8, 3)]),
    "conv1d_valid": ("Convolution1D", (4, 3), {}, [(2, 10, 3)]),
    "conv1d_same_s2": ("Convolution1D", (4, 4),
                       {"border_mode": "same", "subsample_length": 2},
                       [(2, 11, 3)]),
    "atrous1d_same": ("AtrousConvolution1D", (4, 3),
                      {"atrous_rate": 2, "border_mode": "same"},
                      [(2, 10, 3)]),
    "conv3d_valid": ("Convolution3D", (3, 2, 2, 2), {}, [(2, 4, 5, 4, 2)]),
    "conv3d_same_s2": ("Convolution3D", (3, 3, 3, 3),
                       {"border_mode": "same", "subsample": (2, 2, 2)},
                       [(2, 5, 4, 5, 2)]),
    "zeropad1d": ("ZeroPadding1D", (2,), {}, [(2, 5, 3)]),
    "zeropad2d": ("ZeroPadding2D", (((1, 2), (0, 3)),), {}, [(2, 4, 5, 3)]),
    "zeropad3d": ("ZeroPadding3D", (1,), {}, [(2, 3, 4, 2, 2)]),
    "crop1d": ("Cropping1D", ((1, 2),), {}, [(2, 7, 3)]),
    "crop2d": ("Cropping2D", (((1, 0), (2, 1)),), {}, [(2, 6, 7, 3)]),
    "crop3d": ("Cropping3D", (((1, 1), (0, 1), (1, 0)),), {},
               [(2, 4, 4, 4, 2)]),
    "upsample1d": ("UpSampling1D", (3,), {}, [(2, 4, 3)]),
    "upsample2d": ("UpSampling2D", ((2, 3),), {}, [(2, 3, 4, 2)]),
    "upsample3d": ("UpSampling3D", (2,), {}, [(2, 2, 3, 2, 2)]),
}

POOL_CASES = {
    "maxpool2d_valid": ("MaxPooling2D", (), {}, [(2, 8, 8, 3)]),
    "maxpool2d_valid_odd": ("MaxPooling2D", (), {}, [(2, 9, 7, 3)]),
    "maxpool2d_same_3x3_s2_even": ("MaxPooling2D", ((3, 3), (2, 2), "same"),
                                   {}, [(2, 8, 8, 3)]),
    "maxpool2d_same_3x3_s2_odd": ("MaxPooling2D", ((3, 3), (2, 2), "same"),
                                  {}, [(2, 9, 9, 3)]),
    "maxpool2d_overlap_valid": ("MaxPooling2D", ((3, 3), (1, 1)), {},
                                [(2, 6, 6, 2)]),
    "maxpool1d_same": ("MaxPooling1D", (3, 2, "same"), {}, [(2, 9, 3)]),
    "maxpool3d_valid": ("MaxPooling3D", (), {}, [(2, 4, 4, 6, 2)]),
    "maxpool3d_same": ("MaxPooling3D", ((3, 3, 3), (2, 2, 2), "same"), {},
                       [(2, 5, 4, 5, 2)]),
    "avgpool2d_valid": ("AveragePooling2D", (), {}, [(2, 8, 8, 3)]),
    "avgpool2d_same_3x3_s2_even": ("AveragePooling2D",
                                   ((3, 3), (2, 2), "same"), {},
                                   [(2, 8, 8, 3)]),
    "avgpool2d_same_3x3_s1_odd": ("AveragePooling2D",
                                  ((3, 3), (1, 1), "same"), {},
                                  [(2, 7, 7, 3)]),
    "avgpool1d_valid": ("AveragePooling1D", (3,), {}, [(2, 9, 3)]),
    "avgpool1d_same": ("AveragePooling1D", (3, 2, "same"), {},
                       [(2, 10, 3)]),
    "avgpool3d_same": ("AveragePooling3D", ((2, 2, 2), (2, 2, 2), "same"),
                       {}, [(2, 5, 4, 3, 2)]),
    "global_max1d": ("GlobalMaxPooling1D", (), {}, [(2, 7, 3)]),
    "global_max2d": ("GlobalMaxPooling2D", (), {}, [(2, 5, 6, 3)]),
    "global_max3d": ("GlobalMaxPooling3D", (), {}, [(2, 3, 4, 2, 3)]),
    "global_avg1d": ("GlobalAveragePooling1D", (), {}, [(2, 7, 3)]),
    "global_avg2d": ("GlobalAveragePooling2D", (), {}, [(2, 5, 6, 3)]),
    "global_avg3d": ("GlobalAveragePooling3D", (), {}, [(2, 3, 4, 2, 3)]),
}

CORE_CASES = {
    "activation_relu": ("Activation", ("relu",), {}, [(2, 5, 4, 3)]),
    "activation_tanh": ("Activation", ("tanh",), {}, [(2, 6)]),
    "activation_softmax": ("Activation", ("softmax",), {}, [(3, 7)]),
    "activation_sigmoid": ("Activation", ("sigmoid",), {}, [(3, 4, 2)]),
    "flatten": ("Flatten", (), {}, [(2, 3, 4, 5)]),
    "reshape": ("Reshape", ((6, -1),), {}, [(2, 3, 4, 2)]),
    "permute": ("Permute", ((3, 1, 2),), {}, [(2, 3, 4, 5)]),
    "repeat_vector": ("RepeatVector", (3,), {}, [(2, 5)]),
    "identity": ("Identity", (), {}, [(2, 4, 3)]),
    "squeeze": ("Squeeze", (2,), {}, [(2, 3, 1, 4)]),
    "expand_dim": ("ExpandDim", (1,), {}, [(2, 3, 4)]),
    "space_to_depth": ("SpaceToDepth", (2,), {}, [(2, 4, 6, 3)]),
}

MERGE_CASES = {
    f"merge_{mode}": ("Merge", (), {"mode": mode},
                      [(3, 6)] * (2 if mode in ("dot", "cosine") else 3))
    for mode in ("sum", "mul", "max", "min", "ave", "concat", "dot",
                 "cosine")
}
MERGE_CASES["merge_concat_axis1"] = ("Merge", (),
                                     {"mode": "concat", "concat_axis": 1},
                                     [(2, 3, 4), (2, 5, 4)])
MERGE_CASES["merge_sum_nhwc"] = ("Merge", (), {"mode": "sum"},
                                 [(2, 4, 4, 3)] * 2)

ALL_CASES = {**CONV_CASES, **POOL_CASES, **CORE_CASES, **MERGE_CASES}


@pytest.mark.parametrize("case", sorted(ALL_CASES))
def test_layer_matches_jax(case):
    name, args, kwargs, shapes = ALL_CASES[case]
    errs, gerrs = _run(name, args, kwargs, shapes)
    assert max(errs) <= TOL, (case, errs)
    assert max(gerrs) <= TOL, (case, gerrs)


@pytest.mark.parametrize("case", sorted(CONV_CASES) + sorted(POOL_CASES))
def test_output_shape_matches_jax(case):
    name, args, kwargs, shapes = ALL_CASES[case]
    jlayer = getattr(jl, name)(*args, **kwargs)
    tlayer = getattr(tl, name)(*args, **kwargs)
    full = (None,) + tuple(shapes[0][1:])
    want = jlayer.compute_output_shape(full)
    assert tlayer.compute_output_shape(full) == want
    _run_shape = tlayer
    _run_shape.ensure_built(shapes[0][1:])
    rng = np.random.default_rng(0)
    params = {k: torch.tensor(rng.normal(size=v.shape), dtype=torch.float32)
              for k, v in tlayer.init_params(
                  torch.Generator().manual_seed(0)).items()}
    out = tlayer.call(params, torch.randn(shapes[0]))
    assert tuple(out.shape[1:]) == tuple(want[1:])


@pytest.mark.parametrize("kind,pool", [("max", (2, 2)), ("max", (3, 3)),
                                       ("global", None)])
def test_max_pool_ties_route_the_gradient_as_jax(kind, pool):
    """After a ReLU many windows hold equal maxima (zeros); both packages
    give the gradient to the same element of each window."""
    if kind == "global":
        errs, gerrs = _run("GlobalMaxPooling2D", (), {}, [(2, 4, 4, 3)],
                           relu=True)
    else:
        errs, gerrs = _run("MaxPooling2D", (pool, (1, 1)), {},
                           [(2, 7, 7, 3)], seed=3, relu=True)
    assert max(errs) == 0.0
    assert max(gerrs) <= TOL, gerrs


def test_max_pool_tie_goes_to_the_first_maximum():
    x = torch.zeros((1, 2, 2, 1), requires_grad=True)
    tl.MaxPooling2D().call({}, x).sum().backward()
    assert x.grad.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]
    jx = jnp.zeros((1, 2, 2, 1))
    jg = jax.grad(lambda a: jl.MaxPooling2D().call({}, a).sum())(jx)
    assert np.asarray(jg).flatten().tolist() == [1.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("size,k,s,want", [
    (224, 7, 2, (2, 3)),   # ResNet-50's stem conv
    (112, 3, 2, (0, 1)),   # its 3x3/s2 max pool
    (56, 1, 2, (0, 0)),
    (7, 3, 1, (1, 1)),
    (8, 4, 1, (1, 2)),
])
def test_same_pads_are_xlas(size, k, s, want):
    assert same_pads(size, k, s) == want


def test_conv_keeps_channels_last_outputs_contiguous():
    """The NHWC activation goes to the convolution as a channels-first
    view (no copy), and comes back contiguous NHWC."""
    layer = tl.Convolution2D(8, 3, 3, border_mode="same")
    layer.ensure_built((6, 6, 4))
    p = layer.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(2, 6, 6, 4)
    y = layer.call(p, x)
    assert y.shape == (2, 6, 6, 8)
    assert y.is_contiguous()


@pytest.mark.parametrize("init", ["glorot_uniform", "he_normal"])
@pytest.mark.parametrize("shape", [(7, 7, 3, 64), (3, 3, 64, 64),
                                   (1, 1, 256, 64), (5, 16, 32),
                                   (3, 3, 3, 8, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_kernel_initialisers_follow_the_fans(init, shape):
    from analytics_zoo_tpu.pipeline.api.keras.engine import (
        get_initializer as jax_init,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        get_initializer,
    )

    receptive = int(np.prod(shape[:-2]))
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    if init == "glorot_uniform":
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        std, kurtosis = limit / np.sqrt(3.0), 1.8
    else:
        limit, std, kurtosis = None, np.sqrt(2.0 / fan_in), 3.0
    gen = torch.Generator().manual_seed(5)
    port = get_initializer(init)(gen, shape, torch.float32).numpy()
    ref = np.asarray(jax_init(init)(jax.random.PRNGKey(5), shape,
                                    jnp.float32))
    n = port.size
    for sample in (port, ref):
        assert sample.shape == shape
        assert abs(sample.mean()) <= 5 * std / np.sqrt(n)
        # the standard error of a sample's standard deviation
        se = std * np.sqrt((kurtosis - 1) / (4 * n))
        assert abs(sample.std() - std) <= 5 * se
        if limit is not None:
            assert np.abs(sample).max() <= limit
