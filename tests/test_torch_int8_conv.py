"""Calibrated int8 convolutions: the ``int8_conv`` kernel's plain version,
the port's ``_int8_conv`` and calibrated conv nets, against the JAX
package.

- ``int8_conv_reference`` against ``lax.conv_general_dilated(...,
  preferred_element_type=int32)`` on the same int8 operands: equal;
- ``_int8_conv`` against the reference's ``_int8_conv`` on the same layer,
  float input, int8 kernel and activation scale: the int32 sums and the
  f32 output bit for bit, over ranks 1 to 3, SAME and VALID, strides 1 and
  2 on odd sizes, dilation 2, Cin 1, 3 and 64, with and without bias and
  activation (relu: the same f32 function in both);
- calibrated int8 ``ResNet.cifar(8)`` and LeNet-5 on the reference's
  weights (``params_from_jax``) and the same calibration data: the
  activation scales within ``SCALE_RTOL`` (both take the abs-max of the
  same f32 activations, computed by XLA's and PyTorch's convolutions in
  their own orders), the int8 kernels bit for bit, the rows within
  ``ROW_TOL``;
- the port twin of the reference's ``test_int8_conv_accuracy``.

- the padded operands (channels zero-padded to a multiple of 16, the
  weight copy with zero rows per tap) give the unpadded sums; the plain
  epilogue with the precomputed ``mult`` is the reference's rescale, bias
  and activation bit for bit (a -0 before ReLU included);
  ``quantize_act_reference`` is the reference's ``_quantize_act`` bit for
  bit (ties, +-127.5 and the padding); ``Int8Model``'s padded copies and
  its ``mult``; each calibrated layer is one quantization and one
  convolution; the wrapper's tile and split-K plans.

The ``cuda`` tests hold ``csrc/int8_conv.cu`` (the convolution in its
int32 and fused modes, split-K replayed from a graph, the quantization)
against its plain versions bit for bit on a GPU and skip where none is
visible; JAX is imported only inside the tests that compare with it, so
on a machine with a GPU and no JAX they run alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_int8_conv.py

The other tests check on the CPU that the wrapper never falls back: a
tensor on a CUDA device goes to the kernel or raises.
"""

import ast
import inspect

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.ops.cuda import int8_conv as ic
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import same_pads
from analytics_zoo_tpu_torch.pipeline.inference import quantize as tq

# activation scales of a whole calibrated net: the inputs of the later
# layers come from XLA's and PyTorch's float convolutions, which sum in
# their own orders (measured: below 1e-6 relative)
SCALE_RTOL = 1e-5
# calibrated rows of a whole net (softmax outputs): an activation whose
# float input differs by an ulp between the packages can round to the
# neighbouring int8 step at a tie, which moves a logit by act_scale x
# w_scale (measured: 3e-7 and 6e-8 on the two nets below); the count of
# rows above 1e-6 is printed
ROW_TOL = 1e-5

_DIMNUMS = {1: ("NWC", "WIO", "NWC"), 2: ("NHWC", "HWIO", "NHWC"),
            3: ("NDHWC", "DHWIO", "NDHWC")}


@pytest.fixture(autouse=True)
def _restore_contexts():
    saved = engine._CONTEXT
    yield
    engine._CONTEXT = saved
    try:
        import analytics_zoo_tpu.common.engine as jax_engine
        jax_engine._CONTEXT = None
    except ImportError:  # the cuda tests run without the JAX package
        pass


def _pads(spatial, ks, strides, dilation, mode):
    if mode == "same":
        return tuple(same_pads(n, k, s, d)
                     for n, k, s, d in zip(spatial, ks, strides, dilation))
    return ((0, 0),) * len(spatial)


# (rank, batch, spatial, cin, cout, kernel, strides, dilation, mode)
CASES = [
    (1, 2, (11,), 3, 8, (3,), (1,), (1,), "same"),
    (1, 2, (13,), 64, 16, (5,), (2,), (1,), "valid"),
    (1, 3, (17,), 1, 5, (3,), (1,), (2,), "same"),
    (2, 2, (9, 9), 3, 8, (3, 3), (2, 2), (1, 1), "same"),
    (2, 2, (9, 7), 1, 6, (5, 5), (1, 1), (1, 1), "same"),
    (2, 2, (11, 11), 64, 24, (3, 3), (1, 1), (2, 2), "same"),
    (2, 2, (9, 9), 64, 40, (1, 1), (2, 2), (1, 1), "valid"),
    (2, 1, (15, 15), 3, 16, (7, 7), (2, 2), (1, 1), "same"),
    (2, 2, (8, 10), 16, 8, (3, 2), (1, 2), (1, 1), "valid"),
    (3, 2, (5, 6, 7), 3, 4, (3, 2, 3), (2, 1, 2), (1, 1, 1), "same"),
    (3, 1, (5, 5, 5), 64, 8, (3, 3, 3), (1, 1, 1), (1, 1, 1), "valid"),
]
CASE_IDS = [f"r{c[0]}-{'x'.join(map(str, c[2]))}-cin{c[3]}-k"
            f"{'x'.join(map(str, c[5]))}-s{c[6][0]}-d{c[7][0]}-{c[8]}"
            for c in CASES]


def _operands(case, seed=0):
    r, n, spatial, cin, cout, ks, st, dil, mode = case
    gen = np.random.default_rng(seed)
    x = gen.integers(-127, 128, (n,) + spatial + (cin,)).astype(np.int8)
    w = gen.integers(-127, 128, ks + (cin, cout)).astype(np.int8)
    return x, w


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_int8_conv_reference_is_lax(case):
    from jax import lax

    r, n, spatial, cin, cout, ks, st, dil, mode = case
    x, w = _operands(case)
    want = lax.conv_general_dilated(
        x, w, window_strides=st, padding=mode.upper(), rhs_dilation=dil,
        dimension_numbers=_DIMNUMS[r], preferred_element_type=np.int32)
    before = ic.launch_count, ic.plain_count
    got = ic.int8_conv(torch.from_numpy(x),
                       ic.conv_weight_t(torch.from_numpy(w)), ks, st, dil,
                       _pads(spatial, ks, st, dil, mode))
    assert (ic.launch_count, ic.plain_count) == (before[0], before[1] + 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _layers(case, bias, activation):
    """The same conv layer in both packages (Convolution1D/2D/3D, and the
    Atrous classes for a dilation)."""
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl

    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    r, n, spatial, cin, cout, ks, st, dil, mode = case
    kw = dict(border_mode=mode, activation=activation, bias=bias)
    out = []
    for L in (jl, tl):
        if r == 1 and dil[0] > 1:
            layer = L.AtrousConvolution1D(cout, ks[0], atrous_rate=dil[0],
                                          subsample_length=st[0], **kw)
        elif r == 1:
            layer = L.Convolution1D(cout, ks[0], subsample_length=st[0],
                                    **kw)
        elif r == 2 and dil[0] > 1:
            layer = L.AtrousConvolution2D(cout, *ks, atrous_rate=dil,
                                          subsample=st, **kw)
        elif r == 2:
            layer = L.Convolution2D(cout, *ks, subsample=st, **kw)
        else:
            layer = L.Convolution3D(cout, *ks, subsample=st, **kw)
        out.append(layer)
    return out


@pytest.mark.parametrize("bias,activation", [(True, "relu"), (False, None)],
                         ids=["bias-relu", "plain"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_int8_conv_is_the_references(case, bias, activation):
    """The same layer, float input, int8 kernel and activation scale in
    both packages: the int32 sums and the f32 output equal."""
    import jax.numpy as jnp
    from jax import lax

    from analytics_zoo_tpu.pipeline.inference import quantize as jq

    r, n, spatial, cin, cout, ks, st, dil, mode = case
    gen = np.random.default_rng(1)
    x = gen.normal(size=(n,) + spatial + (cin,)).astype(np.float32)
    kernel = gen.normal(size=ks + (cin, cout)).astype(np.float32)
    b = gen.normal(size=(cout,)).astype(np.float32)
    act_scale = float(np.abs(x).max()) / 127.0
    jqt = jq._quantize_array(jnp.asarray(kernel), axis=-1)
    tqt = tq.QuantizedTensor(torch.from_numpy(np.array(jqt.values)),
                             torch.from_numpy(np.array(jqt.scale)), -1)
    jlayer, tlayer = _layers(case, bias, activation)
    params = {"bias": b} if bias else {}
    want = np.asarray(jq._int8_conv(jlayer, jqt, act_scale,
                                    {k: jnp.asarray(v)
                                     for k, v in params.items()},
                                    jnp.asarray(x)))
    w_t = ic.conv_weight_t(tqt.values)
    got = tq._int8_conv(tlayer, tqt, act_scale,
                        {k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), w_t)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the int32 sums of the same int8 input
    xs = np.asarray(jq._quantize_act(jnp.asarray(x), act_scale))
    np.testing.assert_array_equal(
        ic.quantize_act_reference(torch.from_numpy(x), act_scale,
                                  cin).numpy(), xs)
    acc = lax.conv_general_dilated(
        xs, np.asarray(jqt.values), window_strides=st,
        padding=mode.upper(), rhs_dilation=dil,
        dimension_numbers=_DIMNUMS[r], preferred_element_type=np.int32)
    np.testing.assert_array_equal(
        ic.int8_conv(torch.from_numpy(xs), w_t, ks, st, dil,
                     tq._conv_pads(tlayer, spatial)).numpy(),
        np.asarray(acc))


# ---------------------------------------------------------------------------
# calibrated conv nets against the reference
# ---------------------------------------------------------------------------
def _pair(build, seed=3):
    """``build(models)`` in both packages on the CPU, the port's with the
    reference's weights."""
    import jax

    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu import models as jmodels

    import analytics_zoo_tpu_torch.models as tmodels
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.convert import params_from_jax

    jax_init(seed=seed)
    init_zoo_context(seed=seed, device="cpu")
    jnet, tnet = build(jmodels), build(tmodels)
    jnet.build_params()
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    return jnet, tnet


def _calibrated_pair(build, calib, x):
    """(reference Int8Model, port Int8Model, their rows on ``x``)."""
    from analytics_zoo_tpu.pipeline.inference import quantize as jq

    jnet, tnet = _pair(build)
    jm = jq.quantize_model(jnet, calib)
    tm = tq.quantize_model(tnet, calib)
    return jm, tm, jm.predict(x, batch_size=8), tm.predict(x, batch_size=8)


def _check_calibrated(jm, tm, want, got, n_conv):
    """Scales within SCALE_RTOL, int8 kernels equal, rows within ROW_TOL;
    ``n_conv`` conv layers take the int8 path in both."""
    from analytics_zoo_tpu.pipeline.inference import quantize as jq

    assert sorted(tm.act_scales) == sorted(jm.act_scales)
    for name, s in jm.act_scales.items():
        assert tm.act_scales[name] == pytest.approx(s, rel=SCALE_RTOL), name
    hooked = [n for n, g in jm.qparams.items() if isinstance(g, dict)
              and isinstance(g.get("kernel"), jq.QuantizedTensor)]
    assert sorted(tm.weights_t) == sorted(hooked)
    for name in hooked:
        jqt, tqt = jm.qparams[name]["kernel"], tm.qparams[name]["kernel"]
        np.testing.assert_array_equal(tqt.values.numpy(),
                                      np.asarray(jqt.values))
        np.testing.assert_array_equal(tqt.scale.numpy(),
                                      np.asarray(jqt.scale))
    convs = [l for l in tm._targets() if isinstance(l, tq._ConvND)]
    assert len(convs) == n_conv
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - np.asarray(want))
    print(f"calibrated rows: max |d| {diff.max():.3e}, "
          f"{int((diff > 1e-6).sum())} of {diff.size} above 1e-6")
    assert float(diff.max()) <= ROW_TOL


def test_calibrated_cifar_resnet_matches_the_reference():
    """``ResNet.cifar(8)``: its six 3x3 convs and the 1x1 projection to 64
    channels run int8; the stem (432 elements) and the projection to 32
    (512), below min_size, stay float, as in the reference."""
    gen = np.random.default_rng(0)
    calib = gen.normal(size=(16, 32, 32, 3)).astype(np.float32)
    x = gen.normal(size=(8, 32, 32, 3)).astype(np.float32)
    jm, tm, want, got = _calibrated_pair(
        lambda m: m.ResNet.cifar(depth=8), calib, x)
    _check_calibrated(jm, tm, want, got, n_conv=7)


def test_calibrated_lenet_matches_the_reference():
    """LeNet-5: the second conv (1,800 elements) and the three Dense
    layers run int8; the first conv (150) stays float."""
    gen = np.random.default_rng(1)
    calib = gen.normal(size=(16, 28, 28, 1)).astype(np.float32)
    x = gen.normal(size=(8, 28, 28, 1)).astype(np.float32)
    jm, tm, want, got = _calibrated_pair(lambda m: m.build_lenet(), calib, x)
    _check_calibrated(jm, tm, want, got, n_conv=1)


def _train_cnn(seed=5, size=12, n=512, epochs=12):
    """The reference test's CNN and task, trained in the port."""
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Convolution2D,
        Dense,
        Flatten,
        MaxPooling2D,
    )

    init_zoo_context(seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    x = (rng.random((n, size, size, 3)) * 0.5 +
         y[:, None, None, None] * 0.4).astype(np.float32)
    m = Sequential()
    m.add(Convolution2D(8, 3, 3, activation="relu", border_mode="same",
                        input_shape=(size, size, 3)))
    m.add(MaxPooling2D())
    m.add(Flatten())
    m.add(Dense(16, activation="relu"))
    m.add(Dense(2, activation="softmax"))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    m.fit(x, y, batch_size=64, nb_epoch=epochs)
    return m, x, y


def test_int8_conv_accuracy():
    """The twin of the reference's ``test_int8_conv_accuracy``: with
    min_size=1 the conv kernel quantizes and runs int8 x int8, and the
    predictions keep their classes."""
    m, x, y = _train_cnn()
    float_preds = m.predict(x, batch_size=64)
    q = tq.quantize_model(m, x[:128], min_size=1)
    conv_name = m.layers[0].name
    assert isinstance(q.qparams[conv_name]["kernel"], tq.QuantizedTensor)
    before = ic.plain_count
    preds = q.predict(x, batch_size=64)
    assert ic.plain_count - before == 3 * (len(x) // 64)  # conv, 2 Dense
    agree = (preds.argmax(1) == float_preds.argmax(1)).mean()
    assert agree >= 0.97, agree


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------
class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the wrapper sees for a
    CUDA tensor, on a machine that has none."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def _small(seed=0):
    x, w = _operands(CASES[3], seed)
    return torch.from_numpy(x), ic.conv_weight_t(torch.from_numpy(w))


ARGS = ((3, 3), (2, 2), (1, 1), ((1, 1), (1, 1)))


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the kernel runs instead")
    plain = []
    monkeypatch.setattr(ic, "int8_conv_reference",
                        lambda *a: plain.append(1))
    x, w_t = _small()
    with pytest.raises(Exception):
        ic.int8_conv(_OnCuda(x), _OnCuda(w_t), *ARGS)
    assert plain == []


@pytest.mark.parametrize("case,error", [
    ("x_dtype", TypeError), ("w_dtype", TypeError), ("x_rank", ValueError),
    ("k_mismatch", ValueError), ("x_strided", ValueError),
    ("w_strided", ValueError), ("bad_stride", ValueError),
    ("collapsed", ValueError), ("k_too_large", ValueError),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, error):
    """Checked before the library is loaded, so no launch happens."""
    x, w_t = _small()
    args = ARGS
    if case == "x_dtype":
        x = x.to(torch.int32)
    elif case == "w_dtype":
        w_t = w_t.to(torch.int16)
    elif case == "x_rank":
        x = x.reshape(2, -1)
    elif case == "k_mismatch":
        w_t = w_t[:, :20].contiguous()
    elif case == "x_strided":
        x = x.transpose(1, 2)
    elif case == "w_strided":
        w_t = w_t.t().contiguous().t()
    elif case == "bad_stride":
        args = ((3, 3), (0, 2), (1, 1), ((1, 1), (1, 1)))
    elif case == "collapsed":
        args = ((3, 3), (1, 1), (5, 5), ((0, 0), (0, 0)))
    elif case == "k_too_large":
        x = torch.zeros((1, 1, 1, ic.MAX_K + 1), dtype=torch.int8)
        w_t = torch.zeros((1, ic.MAX_K + 1), dtype=torch.int8)
        args = ((1, 1), (1, 1), (1, 1), ((0, 0), (0, 0)))
    before = ic.launch_count
    with pytest.raises(error):
        ic._int8_conv_cuda(_OnCuda(x), _OnCuda(w_t), *args)
    assert ic.launch_count == before


def test_other_devices_raise():
    meta = torch.zeros((1, 4, 4, 3), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ic.int8_conv(meta, torch.zeros((8, 27), dtype=torch.int8,
                                       device="meta"), *ARGS)


def test_wrapper_has_no_try_fallback():
    tree = ast.parse(inspect.getsource(ic))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_largest_k_cannot_wrap():
    assert ic.MAX_K * 127 * 127 <= 2 ** 31 - 1
    assert (ic.MAX_K + 1) * 127 * 127 > 2 ** 31 - 1


# ---------------------------------------------------------------------------
# padding, the epilogue, the quantization and the plans, on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_padded_operands_give_the_unpadded_sums(case):
    """x's channels and each tap's rows of the weight copy zero-padded to
    a multiple of 16: the plain sums equal the unpadded ones."""
    r, n, spatial, cin, cout, ks, st, dil, mode = case
    x, w = _operands(case, seed=6)
    args = (ks, st, dil, _pads(spatial, ks, st, dil, mode))
    want = ic.int8_conv(torch.from_numpy(x),
                        ic.conv_weight_t(torch.from_numpy(w)), *args)
    xp, w_t = _padded(x, w)
    cp = ic.padded_channels(cin)
    assert xp.shape[-1] == cp and cp % 16 == 0 and cp - cin < 16
    assert w_t.shape == (cout, int(np.prod(ks)) * cp)
    taps = w_t.reshape(cout, -1, cp)
    assert not taps[..., cin:].any()
    assert torch.equal(taps[..., :cin].reshape(cout, -1),
                       ic.conv_weight_t(torch.from_numpy(w)))
    assert torch.equal(ic.int8_conv(xp, w_t, *args), want)


@pytest.mark.parametrize("activation", ["linear", "relu"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_epilogue_is_the_references(bias, activation):
    """``int8_epilogue_reference`` with ``mult`` made once (the f32 scale
    tensor times w_scale, as ``Int8Model`` makes it) against the
    reference's ``acc.astype(f32) * (act_scale * w_scale)``, ``+ bias``
    and the activation, bit for bit: zero channels of w_scale make
    negative sums -0 (and -0 + -0 stays -0), which jax.nn.relu turns to
    +0."""
    import jax
    import jax.numpy as jnp

    gen = np.random.default_rng(7)
    cout = 40
    acc = gen.integers(-3_000_000, 3_000_000, (6, 5, cout)).astype(np.int32)
    acc[0, 0] = -5
    acc[1, 1] = 2 ** 30 + 7  # rounds to f32
    w_scale = gen.uniform(1e-4, 1e-2, (1, 1, 1, cout)).astype(np.float32)
    w_scale[..., ::7] = 0.0
    b = gen.normal(size=cout).astype(np.float32)
    b[::7] = -0.0
    act_scale = float(np.float32(0.0371))
    y = jnp.asarray(acc).astype(jnp.float32) * (
        act_scale * jnp.asarray(w_scale).reshape(-1))
    if bias:
        y = y + jnp.asarray(b)
    want = np.asarray(jax.nn.relu(y) if activation == "relu" else y)
    mult = torch.tensor(act_scale, dtype=torch.float32) * torch.from_numpy(
        w_scale).reshape(-1)
    got = ic.int8_epilogue_reference(
        torch.from_numpy(acc), mult,
        torch.from_numpy(b) if bias else None, activation == "relu")
    assert np.signbit(want).any() == (activation != "relu")
    np.testing.assert_array_equal(_bits(got).numpy(),
                                  want.view(np.int32))


def _quantize_inputs(cin, seed=8):
    """f32 activations at a scale, with exact .5 ties of the quotient
    (both parities), +-127.5, values past the clamp and zeros."""
    gen = np.random.default_rng(seed)
    scale = np.float32(0.05)
    x = (gen.normal(size=(3, 5, 4, cin)) * 3).astype(np.float32)
    ties = (np.arange(-130, 130) + 0.5).astype(np.float32) * scale
    flat = x.reshape(-1)
    flat[:ties.size] = ties[:flat.size]
    flat[-4:] = np.array([127.5, -127.5, 1e4, -0.0], np.float32) * scale
    return torch.from_numpy(x), float(scale)


@pytest.mark.parametrize("cin", [3, 16, 20])
def test_quantize_act_reference_is_the_references(cin):
    """``quantize_act_reference`` (and ``quantize_act`` on the CPU) against
    the reference's ``_quantize_act`` bit for bit, by the f32 scale
    tensor and by the float, the padding channels zero."""
    import jax.numpy as jnp

    from analytics_zoo_tpu.pipeline.inference import quantize as jq

    x, scale = _quantize_inputs(cin)
    want = np.asarray(jq._quantize_act(jnp.asarray(x.numpy()), scale))
    cp = ic.padded_channels(cin)
    before = ic.quantize_plain_count
    for s in (torch.tensor(scale, dtype=torch.float32), scale):
        got = ic.quantize_act(x, s)
        assert got.dtype == torch.int8 and got.shape[-1] == cp
        np.testing.assert_array_equal(got[..., :cin].numpy(), want)
        assert not got[..., cin:].any()
    assert ic.quantize_plain_count == before + 2
    assert (want == 127).any() and (want == -127).any()


def test_int8_model_holds_padded_copies_and_mult():
    """``Int8Model``: each hooked kernel's (Cout, K) copy with each tap's
    channels zero-padded to a multiple of 16 (the stem-like conv of 3
    channels, a Dense over 9 x 5 x 5 features), ``mults_t`` the f32
    ``act_scale * w_scale`` of the reference, and its output the
    reference's when the copies are not padded."""
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Convolution2D,
        Dense,
        Flatten,
    )

    init_zoo_context(seed=9, device="cpu")
    m = Sequential()
    m.add(Convolution2D(9, 3, 3, activation="relu", border_mode="valid",
                        input_shape=(7, 7, 3)))
    m.add(Flatten())
    m.add(Dense(4, activation="softmax"))
    m.build_params()
    x = np.random.default_rng(9).normal(size=(8, 7, 7, 3)).astype(
        np.float32)
    q = tq.quantize_model(m, x, min_size=1)
    conv, dense = m.layers[0].name, m.layers[2].name
    for name, k, cp in ((conv, 9, 16), (dense, 1, 240)):
        qt = q.qparams[name]["kernel"]
        w_t = q.weights_t[name]
        cin = qt.values.shape[-2]
        assert w_t.shape == (qt.values.shape[-1], k * cp)
        taps = w_t.reshape(w_t.shape[0], k, cp)
        assert not taps[..., cin:].any()
        assert torch.equal(taps[..., :cin].reshape(w_t.shape[0], -1),
                           ic.conv_weight_t(qt.values))
        want = (np.float32(q.act_scales[name])
                * qt.scale.numpy().reshape(-1))
        assert q.mults_t[name].dtype == torch.float32
        np.testing.assert_array_equal(q.mults_t[name].numpy(), want)
    got = q.predict(x, batch_size=8)
    q.weights_t = {n: ic.conv_weight_t(q.qparams[n]["kernel"].values)
                   for n in q.weights_t}
    np.testing.assert_array_equal(q.predict(x, batch_size=8), got)


def test_each_calibrated_layer_holds_tickets_of_its_own(monkeypatch):
    """``Int8Model.tickets_t``: one zeroed int32 array of TICKETS per
    hooked layer, shared by no other layer and no other model, and the
    one each layer's ``int8_conv`` call is given."""
    m, x, _ = _train_cnn(n=128, epochs=1)
    q1 = tq.quantize_model(m, x[:64], min_size=1)
    q2 = tq.quantize_model(m, x[:64], min_size=1)
    arrays = list(q1.tickets_t.values()) + list(q2.tickets_t.values())
    assert sorted(q1.tickets_t) == sorted(q1.weights_t)
    assert len({t.data_ptr() for t in arrays}) == len(arrays) == 6
    for t in arrays:
        assert t.dtype == torch.int32 and t.shape == (ic.TICKETS,)
        assert not t.any()
    given = []
    conv = tq.int8_conv

    def spy(*args, tickets=None, **kw):
        given.append(tickets)
        return conv(*args, tickets=tickets, **kw)

    monkeypatch.setattr(tq, "int8_conv", spy)
    q1.predict(x[:64], batch_size=64)
    assert [t.data_ptr() for t in given] == [
        q1.tickets_t[l.name].data_ptr() for l in q1._targets()]


@pytest.mark.parametrize("case", ["dtype", "short", "device"])
def test_wrapper_raises_on_tickets_the_kernel_does_not_take(case):
    """Checked before the library is loaded, so no launch happens."""
    x, w = _operands(CASES[3], 0)
    xp, w_t = _padded(x, w)
    tickets = _OnCuda(torch.zeros(ic.TICKETS, dtype=torch.int32))
    if case == "dtype":
        tickets = _OnCuda(torch.zeros(ic.TICKETS, dtype=torch.int64))
    elif case == "short":
        tickets = _OnCuda(torch.zeros(8, dtype=torch.int32))
    elif case == "device":
        tickets = torch.zeros(ic.TICKETS, dtype=torch.int32)
    before = ic.launch_count
    with pytest.raises(ValueError, match="tickets"):
        ic.int8_conv(_OnCuda(xp), _OnCuda(w_t), *ARGS, tickets=tickets)
    assert ic.launch_count == before


def test_a_calibrated_layer_is_one_quantize_and_one_conv():
    """Each hooked layer of a forward calls ``quantize_act`` once and
    ``int8_conv`` once, on the CPU their plain versions."""
    m, x, _ = _train_cnn(n=128, epochs=1)
    q = tq.quantize_model(m, x[:64], min_size=1)
    before = ic.plain_count, ic.quantize_plain_count
    q.predict(x[:64], batch_size=64)
    assert (ic.plain_count - before[0],
            ic.quantize_plain_count - before[1]) == (3, 3)


# (m, k, cout, taps) of ResNet-50's layers at 32 and 1 images, BERT's head
PLAN_SHAPES = [(401408, 784, 64, 49), (100352, 576, 64, 9),
               (25088, 1152, 128, 9), (6272, 2304, 256, 9),
               (1568, 4608, 512, 9), (1568, 2048, 512, 1),
               (25088, 512, 128, 1), (32, 2048, 1000, 1),
               (12544, 784, 64, 49), (784, 1152, 128, 9),
               (49, 4608, 512, 9), (1, 2048, 1000, 1), (8, 768, 2, 1)]


@pytest.mark.parametrize("m,k,cout,taps", PLAN_SHAPES)
def test_plan_fills_the_card_and_covers_k(m, k, cout, taps):
    """The N tile is 64 or 128 (128 only for at least 128 columns, 512
    bytes of K and 8 row tiles); K is split only where the output tiles
    fill less than one block an SM and K has SPLIT_K_TILES K tiles, into
    blocks of at least two K tiles that cover K with none empty."""
    bn, split, per = ic.plan(m, k, cout, taps)
    nk = -(-k // ic.BK)
    tiles = -(-m // ic.BM) * -(-cout // bn)
    assert bn in (64, 128)
    if bn == 128:
        assert cout >= 128 and k >= 512 and m >= 8 * ic.BM - ic.BM + 1
    assert (split - 1) * per < nk <= split * per
    if split > 1:
        assert tiles < ic.SMS and nk >= ic.SPLIT_K_TILES
        assert per >= 2 and split <= ic.MAX_SPLIT and tiles <= ic.TICKETS
    if tiles >= ic.SMS:
        assert split == 1


@pytest.mark.parametrize("case,error", [
    ("bias_without_mult", ValueError), ("mult_dtype", TypeError),
    ("mult_shape", ValueError), ("bias_shape", ValueError),
    ("cin_unaligned", ValueError),
])
def test_wrapper_raises_on_epilogue_operands(case, error):
    """Checked before the library is loaded, so no launch happens."""
    x, w = _operands(CASES[3], 0)
    xp, w_t = _padded(x, w)
    kw = dict(mult=torch.ones(w_t.shape[0]))
    if case == "bias_without_mult":
        kw = dict(bias=torch.ones(w_t.shape[0]))
    elif case == "mult_dtype":
        kw = dict(mult=torch.ones(w_t.shape[0], dtype=torch.float64))
    elif case == "mult_shape":
        kw = dict(mult=torch.ones(w_t.shape[0] + 1))
    elif case == "bias_shape":
        kw["bias"] = torch.ones(3)
    elif case == "cin_unaligned":
        xp, w_t = _small()
    before = ic.launch_count
    with pytest.raises(error):
        ic.int8_conv(_OnCuda(xp), _OnCuda(w_t), *ARGS,
                     **{k: _OnCuda(v) for k, v in kw.items()})
    assert ic.launch_count == before


@pytest.mark.parametrize("case", ["dtype", "cin_p", "scale"])
def test_quantize_wrapper_raises_on_what_the_kernel_does_not_take(case):
    x = torch.zeros((2, 4, 4, 3))
    scale, cin_p = torch.tensor(0.5), 16
    if case == "dtype":
        x = x.double()
    elif case == "cin_p":
        cin_p = 8
    elif case == "scale":
        scale = torch.tensor([0.5, 0.5])
    before = ic.quantize_launch_count
    with pytest.raises((TypeError, ValueError)):
        ic.quantize_act(_OnCuda(x), _OnCuda(scale), cin_p)
    assert ic.quantize_launch_count == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


# the kernel against its plain version: every CASES row, ResNet-50's stem
# at 224 (7x7/2, pads 2 and 3: Cin 3 takes the element gather), a 3x3 of
# 64 channels at 56 and a strided 1x1 projection, BERT's calibrated head
# (a 1x1 over 8 rows, Cout 2) and a ragged Dense (K not a multiple of 16)
CUDA_CASES = CASES + [
    (2, 2, (224, 224), 3, 64, (7, 7), (2, 2), (1, 1), "same"),
    (2, 2, (56, 56), 64, 64, (3, 3), (1, 1), (1, 1), "same"),
    (2, 2, (56, 56), 256, 512, (1, 1), (2, 2), (1, 1), "valid"),
    (1, 8, (1,), 768, 2, (1,), (1,), (1,), "valid"),
    (1, 33, (1,), 203, 70, (1,), (1,), (1,), "valid"),
    # split-K: ResNet-50's last 3x3 and its fc at one image
    (2, 1, (7, 7), 512, 512, (3, 3), (1, 1), (1, 1), "same"),
    (1, 1, (1,), 2048, 1000, (1,), (1,), (1,), "valid"),
]


def _padded(x, w):
    """(x, w_t) as the card takes them: x's channels and each tap's rows
    of the weight copy zero-padded to a multiple of 16."""
    x = torch.from_numpy(x)
    xp = F.pad(x, (0, ic.padded_channels(x.shape[-1]) - x.shape[-1]))
    return xp, ic.conv_weight_t(torch.from_numpy(w), pad=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_kernel_matches_plain_bit_for_bit(case, cuda_device):
    """The int32 sums over the padded operands, against the plain sums
    over the unpadded ones."""
    r, n, spatial, cin, cout, ks, st, dil, mode = case
    x, w = _operands(case, seed=2)
    args = (ks, st, dil, _pads(spatial, ks, st, dil, mode))
    want = ic.int8_conv(torch.from_numpy(x),
                        ic.conv_weight_t(torch.from_numpy(w)), *args)
    xp, w_t = _padded(x, w)
    before = ic.launch_count
    got = ic.int8_conv(xp.to(cuda_device), w_t.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert ic.launch_count == before + 1
    assert torch.equal(got.cpu(), want)


def _epilogue_operands(cout, seed):
    """mult as act_scale * w_scale, with a few zero channels (a negative
    sum then gives -0, which ReLU must turn to +0), and a bias with -0 at
    those channels."""
    gen = np.random.default_rng(seed)
    mult = (np.float32(0.0123) * gen.uniform(
        1e-3, 1e-2, cout).astype(np.float32)).astype(np.float32)
    bias = gen.normal(size=cout).astype(np.float32)
    mult[::7] = 0.0
    bias[::7] = -0.0
    return torch.from_numpy(mult), torch.from_numpy(bias)


def _bits(t):
    return t.contiguous().view(torch.int32)


FUSED_MODES = [(False, False), (True, False), (True, True), (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("bias,relu", FUSED_MODES,
                         ids=["mult", "bias", "bias-relu", "relu"])
@pytest.mark.parametrize("case", CUDA_CASES)
def test_fused_kernel_matches_plain_bit_for_bit(case, bias, relu,
                                                cuda_device):
    r, n, spatial, cin, cout, ks, st, dil, mode = case
    x, w = _operands(case, seed=3)
    args = (ks, st, dil, _pads(spatial, ks, st, dil, mode))
    mult, b = _epilogue_operands(cout, 4)
    b = b if bias else None
    want = ic.int8_epilogue_reference(
        ic.int8_conv(torch.from_numpy(x),
                     ic.conv_weight_t(torch.from_numpy(w)), *args),
        mult, b, relu)
    xp, w_t = _padded(x, w)
    got = ic.int8_conv(xp.to(cuda_device), w_t.to(cuda_device), *args,
                       mult=mult.to(cuda_device),
                       bias=None if b is None else b.to(cuda_device),
                       relu=relu)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [3, 16, 64, 203])
def test_quantize_kernel_matches_plain_bit_for_bit(cin, cuda_device):
    x, scale = _quantize_inputs(cin)
    want = ic.quantize_act_reference(x, torch.tensor(scale),
                                     ic.padded_channels(cin))
    before = ic.quantize_launch_count
    got = ic.quantize_act(x.to(cuda_device),
                          torch.tensor(scale, device=cuda_device))
    torch.cuda.synchronize()
    assert ic.quantize_launch_count == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_split_k_replay_resets_the_tickets(cuda_device):
    """A 3x3 over 512 channels at 7x7 on one image splits K: two replays
    of one captured call give the plain sums both times."""
    case = (2, 1, (7, 7), 512, 512, (3, 3), (1, 1), (1, 1), "same")
    x, w = _operands(case, seed=5)
    args = ((3, 3), (1, 1), (1, 1), ((1, 1), (1, 1)))
    want = ic.int8_conv(torch.from_numpy(x),
                        ic.conv_weight_t(torch.from_numpy(w)), *args)
    assert ic.plan(49, 9 * 512, 512, 9)[1] > 1
    xd, wd = (t.to(cuda_device) for t in _padded(x, w))
    # tickets of the call's own, made before the capture: the graph holds
    # no memset of them, so only the kernel leaves them zeroed
    tk = ic.new_tickets(cuda_device)
    ic.int8_conv(xd, wd, *args, tickets=tk)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ic.int8_conv(xd, wd, *args, tickets=tk)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want)
        assert not tk.any()


@pytest.mark.cuda
def test_split_k_on_two_streams_with_tickets_of_their_own(cuda_device):
    """The split-K call of the test above, 16 times on each of two
    streams at once, each stream with its own tickets (as two calibrated
    models' layers hold them): every result is the plain sums."""
    case = (2, 1, (7, 7), 512, 512, (3, 3), (1, 1), (1, 1), "same")
    x, w = _operands(case, seed=6)
    args = ((3, 3), (1, 1), (1, 1), ((1, 1), (1, 1)))
    want = ic.int8_conv(torch.from_numpy(x),
                        ic.conv_weight_t(torch.from_numpy(w)), *args)
    xd, wd = (t.to(cuda_device) for t in _padded(x, w))
    streams = [torch.cuda.Stream() for _ in range(2)]
    tickets = [ic.new_tickets(cuda_device) for _ in streams]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(16):
        for s, tk in zip(streams, tickets):
            with torch.cuda.stream(s):
                outs.append(ic.int8_conv(xd, wd, *args, tickets=tk))
    torch.cuda.synchronize()
    assert all(torch.equal(o.cpu(), want) for o in outs)


@pytest.mark.cuda
def test_calibrated_conv_request_replay_is_the_eager_forward(cuda_device):
    """A calibrated ``ResNet.cifar(8)`` served from a capture: the replay
    equals its eager forward bit for bit, and each replayed micro-batch
    launches the kernel once per int8 conv and Dense."""
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=3, device="cuda")
    net = ResNet.cifar(depth=8)
    net.build_params()
    gen = np.random.default_rng(0)
    calib = gen.normal(size=(16, 32, 32, 3)).astype(np.float32)
    im = InferenceModel().from_keras_net(net).optimize(
        "int8", calibration_data=calib)
    im.warmup([(32, 32, 3)], batch_sizes=[8])
    x = gen.normal(size=(8, 32, 32, 3)).astype(np.float32)
    eager = im._forward_fn()(im._params, im._state,
                             [torch.from_numpy(x).to(cuda_device)]).cpu()
    before = ic.launch_count, ic.quantize_launch_count
    got = im.predict(x)
    hooked = len(im._int8_model.weights_t)
    assert (ic.launch_count - before[0],
            ic.quantize_launch_count - before[1]) == (hooked, hooked)
    assert np.array_equal(got, eager.numpy())
