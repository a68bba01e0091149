"""The port's depthwise, separable, transposed, locally connected and
shared convolutions, its tensor ops, WithinChannelLRN2D and its core
extras against the JAX package's.

Each deterministic case builds one layer in both packages, gives both the
same numpy parameters (through ``params_from_jax``) and inputs, and holds
the port's forward and its autograd gradients (of the parameters and the
inputs, under one seeded cotangent) against the reference's forward and
``jax.grad``.  Errors are the largest absolute difference relative to the
reference's largest magnitude.  Tolerances:

- 0 (bit for bit) for pure data movement: Narrow, Expand, SelectTable,
  SplitTensor, GetShape, Negative, Masking, forward and gradient (but
  Expand's gradient, a sum over the broadcast dims: 1e-5);
- 1e-5 for the f32 elementwise and product layers, the depthwise,
  separable and shared convolutions among them;
- 1e-4 for the windowed sums: LRN2D, WithinChannelLRN2D, the locally
  connected layers and Deconvolution2D.

``Deconvolution2D`` is held at strides 1 and 2, kernels 3 and 4, SAME and
VALID, on odd sizes; ``LRN2D`` at even and odd ``n``.  The random layers
(SpatialDropout1D/2D/3D, GaussianNoise, GaussianDropout, GaussianSampler,
RReLU) are checked by their statistics and mask shapes, as the reference's
own tests check them, and are the identity (or their mean) at
``training=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

EXACT, ELEMENTWISE, WINDOWED = 0.0, 1e-5, 1e-4
# Expand's forward moves data; its gradient sums over the broadcast dims
EXPAND = (EXACT, ELEMENTWISE)


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(shapes, rng, positive, mask_rows):
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if positive:
        xs = [np.abs(x) + 0.1 for x in xs]
    if mask_rows:  # whole timesteps equal to the mask value (0)
        for x in xs:
            x[:, 1] = 0.0
            x[0, -1] = 0.0
    return xs


def _run(name, args, kwargs, shapes, seed=0, positive=False,
         mask_rows=False, grad=True):
    """(forward errors, gradient errors) of layer ``name`` built with
    ``args``/``kwargs`` on inputs of the (batch-first) ``shapes``."""
    jlayer = getattr(jl, name)(*args, **kwargs)
    tlayer = getattr(tl, name)(*args, **kwargs)
    single = len(shapes) == 1
    build = shapes[0][1:] if single else [s[1:] for s in shapes]
    jlayer.ensure_built(build)
    tlayer.ensure_built(build)
    rng = np.random.default_rng(seed)
    xs = _inputs(shapes, rng, positive, mask_rows)
    specs = jlayer.init_params(jax.random.PRNGKey(0))
    params = {k: (0.5 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in specs.items()}
    tspecs = tlayer.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tspecs.items()} == \
        {k: tuple(v.shape) for k, v in specs.items()}

    def fwd(layer, p, x):
        out = layer.call(p, x[0] if single else x)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx = [jnp.asarray(x) for x in xs]
    want = [np.asarray(o) for o in jax.jit(
        lambda p, x: fwd(jlayer, p, x))(jp, jx)]
    tp = {k: v.requires_grad_() for k, v in
          params_from_jax(params, device="cpu").items()}
    tx = [torch.tensor(x, requires_grad=True) for x in xs]
    got = fwd(tlayer, tp, tx)
    assert len(got) == len(want)
    errs = [_err(g.detach().numpy(), w) for g, w in zip(got, want)]
    if not grad:
        return errs, []
    cots = [rng.normal(size=w.shape).astype(np.float32) for w in want]
    jg = jax.jit(jax.grad(lambda p, x: sum(jnp.sum(o * c) for o, c in
                                           zip(fwd(jlayer, p, x), cots)),
                          argnums=(0, 1)))(jp, jx)
    loss = sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots))
    if loss.requires_grad:  # BinaryThreshold's output has no gradient
        loss.backward()

    def grad(t):
        return np.zeros(t.shape) if t.grad is None else t.grad.numpy()

    gerrs = [_err(grad(tp[k]), jg[0][k]) for k in sorted(params)]
    gerrs += [_err(grad(t), g) for t, g in zip(tx, jg[1])]
    return errs, gerrs


def _deconv_cases():
    cases = {}
    for s in (1, 2):
        for k in (3, 4):
            for mode in ("same", "valid"):
                cases[f"deconv_s{s}_k{k}_{mode}"] = (
                    "Deconvolution2D", (3, k, k),
                    {"subsample": (s, s), "border_mode": mode},
                    [(2, 5, 7, 2)], WINDOWED, {})
    cases["deconv_rect_s21_relu"] = (
        "Deconvolution2D", (4, 3, 2),
        {"subsample": (2, 1), "border_mode": "same", "activation": "relu"},
        [(2, 5, 4, 3)], WINDOWED, {})
    cases["deconv_k1_s2_valid"] = ("Deconvolution2D", (2, 1, 1),
                                   {"subsample": (2, 2)}, [(2, 3, 3, 2)],
                                   WINDOWED, {})
    return cases


# name: (layer, args, kwargs, input shapes, tolerance, options)
CONV_CASES = {
    "depthwise_same_s1": ("DepthwiseConvolution2D", (3, 3),
                          {"border_mode": "same"}, [(2, 7, 7, 4)],
                          ELEMENTWISE, {}),
    "depthwise_same_s2_even_nobias": (
        "DepthwiseConvolution2D", (3, 3),
        {"border_mode": "same", "subsample": (2, 2), "bias": False},
        [(2, 8, 8, 4)], ELEMENTWISE, {}),
    "depthwise_same_s2_odd_relu6": (
        "DepthwiseConvolution2D", (3, 3),
        {"border_mode": "same", "subsample": (2, 2), "activation": "relu6"},
        [(2, 9, 9, 3)], ELEMENTWISE, {}),
    "depthwise_valid_dm2": ("DepthwiseConvolution2D", (3, 2),
                            {"depth_multiplier": 2}, [(2, 6, 5, 3)],
                            ELEMENTWISE, {}),
    "separable_same": ("SeparableConvolution2D", (5, 3, 3),
                       {"border_mode": "same"}, [(2, 6, 6, 3)],
                       ELEMENTWISE, {}),
    "separable_s2_dm3_tanh": ("SeparableConvolution2D", (4, 3, 3),
                              {"border_mode": "same", "subsample": (2, 2),
                               "depth_multiplier": 3, "activation": "tanh"},
                              [(2, 7, 8, 2)], ELEMENTWISE, {}),
    **_deconv_cases(),
    "locally1d": ("LocallyConnected1D", (4, 3), {}, [(2, 9, 3)], WINDOWED,
                  {}),
    "locally1d_s2_relu": ("LocallyConnected1D", (3, 2),
                          {"subsample_length": 2, "activation": "relu"},
                          [(2, 9, 2)], WINDOWED, {}),
    "locally2d": ("LocallyConnected2D", (4, 3, 3), {}, [(2, 6, 5, 2)],
                  WINDOWED, {}),
    "locally2d_rect_s21_nobias": ("LocallyConnected2D", (3, 2, 3),
                                  {"subsample": (2, 1), "bias": False},
                                  [(2, 7, 6, 3)], WINDOWED, {}),
    "shareconv_pad": ("ShareConvolution2D", (4, 3, 3),
                      {"pad_h": 1, "pad_w": 2}, [(2, 6, 5, 3)],
                      ELEMENTWISE, {}),
    "shareconv_s2_no_backprop": ("ShareConvolution2D", (4, 3, 3),
                                 {"subsample": (2, 2), "pad_h": 1,
                                  "pad_w": 1, "propagate_back": False},
                                 [(2, 7, 7, 2)], ELEMENTWISE, {}),
}

POS = {"positive": True}
TENSOR_CASES = {
    "add_constant": ("AddConstant", (1.5,), {}, [(2, 3, 4)], ELEMENTWISE,
                     {}),
    "mul_constant": ("MulConstant", (-0.75,), {}, [(2, 3, 4)], ELEMENTWISE,
                     {}),
    "negative": ("Negative", (), {}, [(2, 3, 4)], EXACT, {}),
    "power": ("Power", (2.5,), {"scale": 0.5, "shift": 0.25}, [(2, 5)],
              ELEMENTWISE, POS),
    "power_square": ("Power", (2.0,), {}, [(2, 5)], ELEMENTWISE, {}),
    "sqrt": ("Sqrt", (), {}, [(2, 3, 4)], ELEMENTWISE, POS),
    "square": ("Square", (), {}, [(2, 3, 4)], ELEMENTWISE, {}),
    "exp": ("Exp", (), {}, [(2, 3, 4)], ELEMENTWISE, {}),
    "log": ("Log", (), {}, [(2, 3, 4)], ELEMENTWISE, POS),
    "binary_threshold": ("BinaryThreshold", (0.2,), {}, [(3, 6)],
                         ELEMENTWISE, {}),
    "threshold": ("Threshold", (0.1, -2.0), {}, [(3, 6)], ELEMENTWISE, {}),
    "hard_shrink": ("HardShrink", (0.5,), {}, [(3, 6)], ELEMENTWISE, {}),
    "soft_shrink": ("SoftShrink", (0.4,), {}, [(3, 6)], ELEMENTWISE, {}),
    "hard_tanh": ("HardTanh", (-0.5, 0.8), {}, [(3, 6)], ELEMENTWISE, {}),
    "rrelu_eval": ("RReLU", (), {}, [(3, 6)], ELEMENTWISE, {}),
    "softmax_2d": ("Softmax", (), {}, [(3, 7)], ELEMENTWISE, {}),
    "softmax_3d": ("Softmax", (), {}, [(2, 3, 5)], ELEMENTWISE, {}),
    "cadd": ("CAdd", ((3, 1),), {}, [(2, 3, 4)], ELEMENTWISE, {}),
    "cmul": ("CMul", ((1, 4),), {}, [(2, 3, 4)], ELEMENTWISE, {}),
    "scale": ("Scale", ((3, 4),), {}, [(2, 3, 4)], ELEMENTWISE, {}),
    "mul": ("Mul", (), {}, [(2, 3, 4)], ELEMENTWISE, {}),
    "gaussian_sampler_eval": ("GaussianSampler", (), {},
                              [(3, 4), (3, 4)], ELEMENTWISE, {}),
    "expand": ("Expand", ((3, 4),), {}, [(2, 1, 4)], EXPAND, {}),
    "expand_both": ("Expand", ((3, 4, 5),), {}, [(2, 3, 1, 1)], EXPAND,
                    {}),
    "narrow": ("Narrow", (1, 1, 2), {}, [(2, 5, 3)], EXACT, {}),
    "narrow_to_end": ("Narrow", (2, 1, -1), {}, [(2, 5, 4)], EXACT, {}),
    "max": ("Max", (1,), {}, [(2, 5, 3)], ELEMENTWISE, {}),
    "max_keep_dim": ("Max", (2, True), {}, [(2, 5, 3)], ELEMENTWISE, {}),
    "select_table": ("SelectTable", (1,), {}, [(2, 3), (2, 4), (2, 5)],
                     EXACT, {}),
    "split_tensor": ("SplitTensor", (1, 3), {}, [(2, 6, 4)], EXACT, {}),
    "split_tensor_last": ("SplitTensor", (-1, 2), {}, [(2, 3, 4)], EXACT,
                          {}),
    **{f"lrn2d_n{n}": ("LRN2D", (), {"n": n, "alpha": 0.5, "k": 2.0},
                       [(2, 3, 4, 7)], WINDOWED, {}) for n in (5, 4, 3, 2)},
    "lrn2d_default": ("LRN2D", (), {}, [(2, 5, 5, 8)], WINDOWED, {}),
    "resize_up": ("ResizeBilinear", (7, 9), {}, [(2, 4, 5, 3)],
                  ELEMENTWISE, {}),
    "resize_down": ("ResizeBilinear", (3, 2), {}, [(2, 7, 5, 3)],
                    ELEMENTWISE, {}),
    "resize_up_align_corners": ("ResizeBilinear", (7, 9),
                                {"align_corners": True}, [(2, 4, 5, 3)],
                                ELEMENTWISE, {}),
    "resize_axis_of_one_align_corners": ("ResizeBilinear", (1, 6),
                                         {"align_corners": True},
                                         [(2, 4, 5, 2)], ELEMENTWISE, {}),
    "space_to_depth": ("SpaceToDepth", (2,), {}, [(2, 4, 6, 3)], EXACT, {}),
}

NORM_CASES = {
    f"within_channel_lrn_{size}": ("WithinChannelLRN2D", (size,),
                                   {"alpha": 0.5}, [(2, 7, 6, 3)],
                                   WINDOWED, {})
    for size in (5, 4, 3)
}

CORE_CASES = {
    "masking": ("Masking", (), {}, [(3, 5, 4)], EXACT, {"mask_rows": True}),
    "masking_value": ("Masking", (0.0,), {}, [(2, 4, 6, 3)], EXACT,
                      {"mask_rows": True}),
    "highway": ("Highway", (), {}, [(3, 6)], ELEMENTWISE, {}),
    "highway_relu_nobias": ("Highway", ("relu", False), {}, [(3, 6)],
                            ELEMENTWISE, {}),
    "select": ("Select", (1, 2), {}, [(2, 4, 3)], EXACT, {}),
    "select_last": ("Select", (-1, 0), {}, [(2, 4, 3)], EXACT, {}),
    "maxout_dense": ("MaxoutDense", (5, 3), {}, [(4, 6)], ELEMENTWISE, {}),
    "maxout_dense_3d": ("MaxoutDense", (3,), {}, [(2, 3, 6)], ELEMENTWISE,
                        {}),
    "sparse_dense_dense_input": ("SparseDense", (5,), {}, [(4, 7)],
                                 ELEMENTWISE, {}),
    "sparse_dense_dense_window": ("SparseDense", (5,),
                                  {"backward_start": 2,
                                   "backward_length": 3}, [(4, 7)],
                                  ELEMENTWISE, {}),
    # eval mode of the random layers: the identity
    "spatial_dropout1d_eval": ("SpatialDropout1D", (0.5,), {}, [(2, 5, 3)],
                               EXACT, {}),
    "spatial_dropout3d_eval": ("SpatialDropout3D", (0.5,), {},
                               [(2, 3, 2, 2, 3)], EXACT, {}),
    "gaussian_noise_eval": ("GaussianNoise", (0.5,), {}, [(2, 5)], EXACT,
                            {}),
    "gaussian_dropout_eval": ("GaussianDropout", (0.3,), {}, [(2, 5)],
                              EXACT, {}),
}

ALL_CASES = {**CONV_CASES, **TENSOR_CASES, **NORM_CASES, **CORE_CASES}


@pytest.mark.parametrize("case", sorted(ALL_CASES))
def test_layer_matches_jax(case):
    name, args, kwargs, shapes, tol, opts = ALL_CASES[case]
    fwd_tol, grad_tol = tol if isinstance(tol, tuple) else (tol, tol)
    errs, gerrs = _run(name, args, kwargs, shapes, **opts)
    assert max(errs) <= fwd_tol, (case, errs)
    assert max(gerrs) <= grad_tol, (case, gerrs)


@pytest.mark.parametrize("case", sorted(CONV_CASES) + sorted(NORM_CASES)
                         + ["lrn2d_n4", "resize_down", "narrow_to_end",
                            "split_tensor", "max_keep_dim"])
def test_output_shape_matches_jax(case):
    name, args, kwargs, shapes, _, _ = ALL_CASES[case]
    jlayer = getattr(jl, name)(*args, **kwargs)
    tlayer = getattr(tl, name)(*args, **kwargs)
    full = (None,) + tuple(shapes[0][1:])
    want = jlayer.compute_output_shape(full)
    assert tlayer.compute_output_shape(full) == want
    tlayer.ensure_built(shapes[0][1:])
    params = tlayer.init_params(torch.Generator().manual_seed(0))
    out = tlayer.call(params, torch.randn(shapes[0]))
    outs = out if isinstance(out, list) else [out]
    wants = want if isinstance(want, list) else [want]
    assert [tuple(o.shape[1:]) for o in outs] == \
        [tuple(w[1:]) for w in wants]


def test_get_shape_is_the_input_shape():
    x = np.zeros((3, 4, 5), np.float32)
    want = np.asarray(jl.GetShape().call({}, jnp.asarray(x)))
    got = tl.GetShape().call({}, torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert tl.GetShape().compute_output_shape((None, 4, 5)) == \
        jl.GetShape().compute_output_shape((None, 4, 5)) == (3,)


@pytest.mark.parametrize("window", [None, (2, 3), (4, -1)],
                         ids=["no_window", "start2_len3", "start4_to_end"])
def test_sparse_dense_coo_matches_jax(window):
    """The COO triple: ``index_add`` against the reference's segment sum,
    forward and the gradients of the values, the kernel and the bias;
    the 1-based ``backward_start`` window stops the gradient of the
    values outside it."""
    kw = {} if window is None else {"backward_start": window[0],
                                    "backward_length": window[1]}
    n, feat, out = 4, 9, 5
    jlayer, tlayer = jl.SparseDense(out, **kw), tl.SparseDense(out, **kw)
    jlayer.ensure_built((feat,))
    tlayer.ensure_built((feat,))
    rng = np.random.default_rng(7)
    idx = np.stack([rng.integers(0, n, 14), rng.integers(0, feat, 14)],
                   axis=1).astype(np.int32)
    vals = rng.normal(size=14).astype(np.float32)
    params = {"kernel": rng.normal(size=(feat, out)).astype(np.float32),
              "bias": rng.normal(size=(out,)).astype(np.float32)}
    cot = rng.normal(size=(n, out)).astype(np.float32)

    def jf(p, v):
        return jnp.sum(jlayer.call(p, (jnp.asarray(idx), v, (n, feat)))
                       * cot)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(jlayer.call(jp, (jnp.asarray(idx), jnp.asarray(vals),
                                       (n, feat))))
    jgp, jgv = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(vals))
    tp = {k: v.requires_grad_() for k, v in
          params_from_jax(params, device="cpu").items()}
    tv = torch.tensor(vals, requires_grad=True)
    got = tlayer.call(tp, (torch.from_numpy(idx).long(), tv, (n, feat)))
    (got * torch.from_numpy(cot)).sum().backward()
    assert _err(got.detach().numpy(), want) <= ELEMENTWISE
    assert _err(tv.grad.numpy(), jgv) <= ELEMENTWISE
    for k in params:
        assert _err(tp[k].grad.numpy(), jgp[k]) <= ELEMENTWISE, k
    if window is not None:
        lo = window[0] - 1
        hi = feat if window[1] < 0 else lo + window[1]
        outside = (idx[:, 1] < lo) | (idx[:, 1] >= hi)
        assert outside.any()
        assert np.all(tv.grad.numpy()[outside] == 0.0)


def test_sparse_dense_rejects_a_zero_based_start():
    for pkg in (jl, tl):
        with pytest.raises(ValueError, match="1-based"):
            pkg.SparseDense(3, backward_start=0)


def test_locally_connected_2d_refuses_same():
    with pytest.raises(ValueError, match="valid"):
        tl.LocallyConnected2D(2, 3, 3, border_mode="same")


# ---------------------------------------------------------------------------
# the random layers: statistics and mask shapes
# ---------------------------------------------------------------------------
def _train(layer, x, seed):
    layer.ensure_built(tuple(x.shape[1:]) if not isinstance(x, list)
                       else [tuple(a.shape[1:]) for a in x])
    out, _ = layer.apply({}, x, training=True,
                         rng=torch.Generator().manual_seed(seed))
    return out


@pytest.mark.parametrize("name,shape", [
    ("SpatialDropout1D", (8, 16, 32)),
    ("SpatialDropout2D", (4, 5, 6, 8)),
    ("SpatialDropout3D", (4, 3, 4, 5, 8)),
])
def test_spatial_dropout_drops_whole_maps(name, shape):
    x = torch.ones(shape)
    tr = _train(getattr(tl, name)(0.5), x, 4).numpy()
    maps = tr.reshape(shape[0], -1, shape[-1])
    for b in range(shape[0]):
        for c in range(shape[-1]):
            col = maps[b, :, c]
            assert (col == 0).all() or np.allclose(col, 2.0), (b, c)
    kept = (maps[:, 0, :] != 0).mean()
    assert 0.2 < kept < 0.8, kept
    ev, _ = getattr(tl, name)(0.5).apply({}, x, training=False)
    assert torch.equal(ev, x)


def test_spatial_dropout_keep_rate():
    x = torch.ones((400, 3, 250))
    kept = (_train(tl.SpatialDropout1D(0.3), x, 9)[:, 0, :] != 0).float()
    # 100,000 Bernoulli(0.7) draws: standard error 0.0014
    assert abs(float(kept.mean()) - 0.7) < 0.01


def test_gaussian_noise_statistics():
    x = torch.zeros((200, 200))
    tr = _train(tl.GaussianNoise(0.5), x, 2)
    assert abs(float(tr.std()) - 0.5) < 0.01
    assert abs(float(tr.mean())) < 0.01
    ev, _ = tl.GaussianNoise(0.5).apply({}, x, training=False)
    assert torch.equal(ev, x)


def test_gaussian_dropout_statistics():
    x = torch.ones((200, 200))
    tr = _train(tl.GaussianDropout(0.3), x, 3)
    assert abs(float(tr.mean()) - 1.0) < 0.01
    assert abs(float(tr.std()) - np.sqrt(0.3 / 0.7)) < 0.02
    ev, _ = tl.GaussianDropout(0.3).apply({}, x, training=False)
    assert torch.equal(ev, x)


def test_gaussian_sampler_statistics():
    mean = torch.full((200, 200), 1.5)
    log_var = torch.full((200, 200), float(np.log(0.25)))
    tr = _train(tl.GaussianSampler(), [mean, log_var], 5)
    assert abs(float(tr.mean()) - 1.5) < 0.01
    assert abs(float(tr.std()) - 0.5) < 0.01


def test_rrelu_slopes_are_uniform_in_training():
    lower, upper = 0.1, 0.3
    x = -torch.ones((200, 200))
    slope = -_train(tl.RReLU(lower, upper), x, 6)
    assert float(slope.min()) >= lower and float(slope.max()) <= upper
    assert abs(float(slope.mean()) - (lower + upper) / 2) < 0.002
    # U(l, u) has standard deviation (u - l) / sqrt(12)
    assert abs(float(slope.std()) - (upper - lower) / np.sqrt(12)) < 0.002
    pos = torch.ones((3, 4))
    assert torch.equal(_train(tl.RReLU(lower, upper), pos, 6), pos)


def test_random_layers_draw_anew_each_step_key():
    """Each step's key gives a random layer another draw, and the same
    key the same draw (a train step's generators come from its key)."""
    from analytics_zoo_tpu_torch.common import engine

    layer = tl.SpatialDropout2D(0.5)
    layer.ensure_built((3, 3, 16))
    x = torch.ones((4, 3, 3, 16))
    draws = [layer.apply({}, x, training=True,
                         rng=engine.step_generator(11, step))[0]
             for step in (0, 1, 0)]
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(draws[0], draws[2])


def test_calibrated_int8_of_a_share_convolution_raises():
    """ShareConvolution2D is a ``_ConvND``, as in the reference.  With
    explicit pads its int8 path would not apply them (the reference's
    ``_int8_conv`` pads by ``border_mode``, which is ``"valid"``, and then
    fails on the next layer's shape), so calibrating a net that hooks one
    raises a ValueError naming that fault; weight-only int8 serves it."""
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    with _cpu_context():
        net, x = _share_convolution_net(tl, pad=1)
        with pytest.raises(ValueError, match="explicit pads"):
            InferenceModel().from_keras_net(net).optimize(
                "int8", calibration_data=x)
        out = InferenceModel().from_keras_net(net).optimize(
            "int8").predict(x)
    assert out.shape == (4, 3) and np.isfinite(out).all()


def test_calibrated_int8_of_an_unpadded_share_convolution_matches():
    """Without pads the calibrated ShareConvolution2D runs ``_int8_conv``
    in both packages: on the reference's weights and calibration data the
    same activation scales, the same int8 kernel and, through the int8
    conv, the same rows within 1e-6."""
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.inference import quantize as jq

    from analytics_zoo_tpu_torch.pipeline.inference import quantize as tq

    jax_init(seed=0)
    jnet, x = _share_convolution_net(jl, pad=0)
    with _cpu_context():
        tnet, _ = _share_convolution_net(tl, pad=0)
        tnet.set_weights(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
        jm = jq.quantize_model(jnet, x)
        tm = tq.quantize_model(tnet, x)
        assert sorted(tm.act_scales) == sorted(jm.act_scales)
        for name, s in jm.act_scales.items():
            assert tm.act_scales[name] == pytest.approx(s, rel=1e-6)
        # the Dense kernel (768 elements) stays float, as in the reference
        (conv,) = tm.weights_t
        assert conv.startswith("shareconvolution2d")
        np.testing.assert_array_equal(
            tm.qparams[conv]["kernel"].values.numpy(),
            np.asarray(jm.qparams[conv]["kernel"].values))
        np.testing.assert_allclose(tm.predict(x, batch_size=4),
                                   jm.predict(x, batch_size=4), atol=1e-6)


class _cpu_context:
    """The port's context on the CPU for a block, the old one back
    after."""

    def __enter__(self):
        from analytics_zoo_tpu_torch import init_zoo_context
        from analytics_zoo_tpu_torch.common import engine

        self.saved = engine._CONTEXT
        init_zoo_context(seed=0, device="cpu")

    def __exit__(self, *exc):
        from analytics_zoo_tpu_torch.common import engine

        engine._CONTEXT = self.saved


def _share_convolution_net(layers, pad):
    """ShareConvolution2D (kernel 3x3x8x16: 1,152 elements, above
    min_size, so it is hooked) -> Flatten -> Dense(3, softmax), built,
    and four seeded inputs."""
    from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSeq

    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential

    net = (Sequential if layers is tl else JSeq)()
    net.add(layers.ShareConvolution2D(16, 3, 3, pad_h=pad, pad_w=pad,
                                      input_shape=(6, 6, 8)))
    net.add(layers.Flatten())
    net.add(layers.Dense(3, activation="softmax"))
    net.build_params()
    x = np.random.default_rng(0).normal(size=(4, 6, 6, 8)).astype(
        np.float32)
    return net, x
