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

The ``cuda`` tests hold ``csrc/int8_conv.cu`` against its plain version
bit for bit on a GPU and skip where none is visible; JAX is imported only
inside the tests that compare with it, so on a machine with a GPU and no
JAX they run alone:

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
        tq._quantize_act(torch.from_numpy(x), act_scale).numpy(), xs)
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
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_kernel_matches_plain_bit_for_bit(case, cuda_device):
    r, n, spatial, cin, cout, ks, st, dil, mode = case
    x, w = _operands(case, seed=2)
    x = torch.from_numpy(x)
    w_t = ic.conv_weight_t(torch.from_numpy(w))
    args = (ks, st, dil, _pads(spatial, ks, st, dil, mode))
    want = ic.int8_conv(x, w_t, *args)
    before = ic.launch_count
    got = ic.int8_conv(x.to(cuda_device), w_t.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert ic.launch_count == before + 1
    assert torch.equal(got.cpu(), want)


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
    before = ic.launch_count
    got = im.predict(x)
    hooked = len(im._int8_model.weights_t)
    assert ic.launch_count - before == hooked
    assert np.array_equal(got, eager.numpy())
