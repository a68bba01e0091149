"""The port's int8 serving slice against the JAX package's.

Plan-aware weight-only quantization, activation calibration and the
calibrated ``Int8Model``/``InferenceModel.optimize("int8",
calibration_data=...)``, on the same weights (the reference's, copied with
``params_from_jax``) and the same seeded numpy inputs, plus twins of
``tests/test_int8_calibration.py`` for Dense models (the conv ones are in
``tests/test_torch_int8_conv.py``).

Tolerances:
- quantized values and scales: bitwise (both round half to even);
- activation scales: 1e-6 relative (both take the abs-max of the same f32
  activations, computed in another order after the first layer);
- calibrated predictions: 1e-5 absolute on softmax outputs, and the first
  target's int32 accumulator exactly (same int8 inputs, exact sums).  A
  later target's input can differ by an ulp between the frameworks, which
  moves an activation by one int8 step where it sits on a rounding
  boundary; measured differences are ~1e-7.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import init_zoo_context as torch_init
from analytics_zoo_tpu_torch.common.utils import tree_leaves
from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.ops.cuda import int8_conv as ic
from analytics_zoo_tpu_torch.parallel import int8_serving
from analytics_zoo_tpu_torch.parallel.partition import (
    leaf_path_name,
    tree_map_with_path,
)
from analytics_zoo_tpu_torch.pipeline.inference import quantize as tq

PRED_TOL = 1e-5
SCALE_RTOL = 1e-6
SEQ, VOCAB = 64, 50


@pytest.fixture(autouse=True)
def _restore_contexts():
    """Both packages keep a global context; leave them as found."""
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine

    saved = jax_engine._CONTEXT, torch_engine._CONTEXT
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved


def _mlp(keras, layers):
    m = keras.Sequential()
    m.add(layers.Dense(64, activation="relu", input_shape=(32,)))
    m.add(layers.Dense(32, activation="relu"))
    m.add(layers.Dense(4, activation="softmax"))
    return m


def _bert(keras, layers):
    """A small BERT over token ids with two top-level Dense layers."""
    ids = keras.Input((SEQ,))
    _, pooled = layers.BERT(vocab=VOCAB, hidden_size=64, n_block=2, n_head=1,
                            seq_len=SEQ, intermediate_size=128)(ids)
    h = layers.Dense(32, activation="relu")(pooled)
    return keras.Model(ids, layers.Dense(3, activation="softmax")(h))


def _pair(builder, seed=0):
    """(jax net, port net) over the reference's weights, on the CPU."""
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jk
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    jax_init(seed=seed)
    torch_init(seed=seed, device="cpu")
    jnet = builder(jk, jl)
    jnet.build_params()
    tnet = builder(tk, tl)
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    return jnet, tnet


def _mlp_x(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 32)).astype(
        np.float32)


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (n, SEQ)).astype(np.int32)


def _jq():
    from analytics_zoo_tpu.pipeline.inference import quantize as jq

    return jq


# ---------------------------------------------------------------------------
# plan-aware weight-only quantization
# ---------------------------------------------------------------------------


def _quantized_leaves(tree, is_q, path_of):
    return {path_of(p): l for p, l in tree if is_q(l)}


@pytest.mark.parametrize("min_size", [1024, 1])
def test_quantize_params_for_plan_is_bitwise_the_reference(min_size):
    from analytics_zoo_tpu.parallel.partition import (
        leaf_path_name as jax_name,
    )
    from analytics_zoo_tpu.parallel.plan import int8_serving as jax_int8

    jq = _jq()
    jnet, tnet = _pair(_bert)
    jtree = jq.quantize_params_for_plan(jnet.params, jax_int8(), min_size)
    ttree = tq.quantize_params_for_plan(tnet.params, int8_serving(),
                                        min_size)
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda l: isinstance(l, jq.QuantizedTensor))
    want = {jax_name(p): l for p, l in jflat
            if isinstance(l, jq.QuantizedTensor)}
    got = {}
    tree_map_with_path(
        lambda p, l: got.__setitem__(leaf_path_name(p), l)
        if isinstance(l, tq.QuantizedTensor) else None, ttree)
    assert sorted(got) == sorted(want) and len(got) >= 9
    for path, jl in want.items():
        tl = got[path]
        assert tl.axis == jl.axis and tl.values.dtype == torch.int8
        np.testing.assert_array_equal(tl.values.numpy(),
                                      np.asarray(jl.values))
        np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    # unquantized leaves are the same tensors
    n_float = sum(not isinstance(l, tq.QuantizedTensor)
                  for l in tree_leaves(ttree))
    assert n_float == len(tree_leaves(tnet.params)) - len(got)


def test_quantize_params_for_plan_respects_roles():
    params = {"dense_0": {"kernel": torch.ones(64, 64),
                          "bias": torch.ones(64)},
              "norm": {"scale": torch.ones(64)},
              "big": {"kernel": torch.ones(64, 64)}}
    q = tq.quantize_params_for_plan(params, int8_serving())
    assert isinstance(q["dense_0"]["kernel"], tq.QuantizedTensor)
    assert not isinstance(q["dense_0"]["bias"], tq.QuantizedTensor)
    assert not isinstance(q["norm"]["scale"], tq.QuantizedTensor)
    from analytics_zoo_tpu_torch.parallel import ShardingPlan

    only = ShardingPlan(name="t", dtype_rules=((r"^big/", "int8"),))
    q2 = tq.quantize_params_for_plan(params, only)
    assert isinstance(q2["big"]["kernel"], tq.QuantizedTensor)
    assert not isinstance(q2["dense_0"]["kernel"], tq.QuantizedTensor)
    noop = ShardingPlan(name="t", dtype_rules=((".*", "bf16"),))
    assert tq.quantize_params_for_plan(params, noop) is params


# ---------------------------------------------------------------------------
# calibration and the calibrated Int8Model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder,data", [(_mlp, _mlp_x), (_bert, _ids)],
                         ids=["mlp", "bert"])
def test_calibrated_model_matches_reference(builder, data):
    jq = _jq()
    jnet, tnet = _pair(builder)
    calib, x = data(40, 1), data(37, 2)
    batches = [calib[:16], calib[16:]]
    js = jq.calibrate_activations(jnet, batches)
    ts = tq.calibrate_activations(tnet, batches)
    assert sorted(js) == sorted(ts) and len(ts) >= 2
    for name in js:
        assert ts[name] == pytest.approx(js[name], rel=SCALE_RTOL)
    jm = jq.quantize_model(jnet, calib, batch_size=16, min_size=1)
    tm = tq.quantize_model(tnet, calib, batch_size=16, min_size=1)
    np.testing.assert_allclose(tm.predict(x, batch_size=16),
                               jm.predict(x, batch_size=16),
                               rtol=0, atol=PRED_TOL)
    # the first target's int8 activations and int32 accumulator are equal
    first = [l.name for l in tnet.layers if l.name in ts][0]
    inp = x[:16] if builder is _mlp else None
    if inp is not None:
        jqt, tqt = jm.qparams[first]["kernel"], tm.qparams[first]["kernel"]
        jxs = jq._quantize_act(jax.numpy.asarray(inp), jm.act_scales[first])
        txs = ic.quantize_act_reference(torch.from_numpy(inp),
                                        tm.act_scales[first], inp.shape[-1])
        np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
        jacc = jax.lax.dot_general(jxs, jqt.values, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jax.numpy.int32)
        tacc = ic.int8_conv(txs.reshape(-1, 1, txs.shape[-1]),
                            ic.conv_weight_t(tqt.values), (1,), (1,), (1,),
                            ((0, 0),)).reshape(txs.shape[0], -1)
        assert tacc.dtype == torch.int32
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))


@pytest.mark.parametrize("builder,data", [(_mlp, _mlp_x), (_bert, _ids)],
                         ids=["mlp", "bert"])
def test_inference_model_calibrated_matches_reference(builder, data):
    from analytics_zoo_tpu.pipeline.inference.inference_model import (
        InferenceModel as JaxIM,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import (
        InferenceModel as TorchIM,
    )

    jnet, tnet = _pair(builder)
    calib, x = data(48, 3), data(21, 4)
    jim = JaxIM().from_keras_net(jnet).optimize("int8",
                                                calibration_data=calib)
    tim = TorchIM().from_keras_net(tnet).optimize("int8",
                                                  calibration_data=calib)
    assert tim._int8_model is not None and tim._quantized
    for bs in (8, None):
        np.testing.assert_allclose(tim.predict(x, batch_size=bs),
                                   jim.predict(x, batch_size=bs),
                                   rtol=0, atol=PRED_TOL)
    # bf16 ignores calibration data, as in the reference
    jim.optimize("bf16", calibration_data=calib)
    tim.optimize("bf16", calibration_data=calib)
    assert tim._int8_model is None and tim._bf16
    np.testing.assert_allclose(tim.predict(x), jim.predict(x), rtol=0,
                               atol=2 ** -7)


def test_int8_dense_runs_int8():
    """The hooked path quantizes its inputs: outputs lie on the scale grid
    of an int8 x int8 product (the reference's test_int8_matmul_actually_int8
    twin)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    x = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    m = Sequential()
    m.add(Dense(64, bias=False, input_shape=(64,)))
    m.build_params(rng=torch.Generator().manual_seed(0), device="cpu")
    scales = tq.calibrate_activations(m, [x])
    qp = tq.quantize_params(m.params, min_size=1)
    out = tq.Int8Model(m, qp, scales).predict(x)
    name = m.layers[0].name
    qt, s = qp[name]["kernel"], scales[name]
    xs = np.clip(np.round(x / np.float32(s)), -127, 127).astype(np.int32)
    ref = (xs @ qt.values.numpy().astype(np.int32)).astype(np.float32)
    ref = ref * (np.float32(s) * qt.scale.numpy().reshape(-1))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# twins of tests/test_int8_calibration.py (Dense models)
# ---------------------------------------------------------------------------


def _port_mlp(seed=0):
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    torch_init(seed=seed, device="cpu")
    m = _mlp(tk, tl)
    m.build_params()
    return m


def _forward(m, x):
    with torch.inference_mode():
        return m.forward(m.params, torch.from_numpy(x), state=m.state)[0]


def test_hooks_are_restored():
    m = _port_mlp()
    x = _mlp_x(8)
    applies = [l.apply for l in m.layers]
    ref = _forward(m, x)
    scales = tq.calibrate_activations(m, [x])
    assert len(scales) == 3
    assert [l.apply for l in m.layers] == applies
    torch.testing.assert_close(_forward(m, x), ref, rtol=0, atol=0)
    assert len(scales) == 3  # no new entries appeared


def test_float_path_untouched_after_predict():
    m = _port_mlp()
    x = _mlp_x(16)
    before = _forward(m, x)
    q = tq.quantize_model(m, _mlp_x(64, 1))
    q.predict(x, batch_size=16)
    torch.testing.assert_close(_forward(m, x), before, rtol=0, atol=0)


def test_switching_precision_resets_calibration():
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    m = _port_mlp(2)
    x = _mlp_x(32)
    ref = InferenceModel().from_keras_net(m).predict(x)
    im = InferenceModel().from_keras_net(m)
    im.optimize("int8", calibration_data=_mlp_x(64, 1))
    int8_preds = im.predict(x)
    im.optimize("bf16")
    assert im._int8_model is None
    bf16_preds = im.predict(x)
    assert np.abs(bf16_preds - ref).max() < 0.02
    assert not np.array_equal(bf16_preds, int8_preds)
    im.optimize("int8")  # weight-only after calibrated: no stale hooks
    assert im._int8_model is None
    assert im.predict(x).shape == ref.shape


def test_only_hooked_kernels_quantized():
    """A BERT nested in the model is no target, so its weights stay float
    even at min_size=1; only the top-level Dense kernels turn int8."""
    _, tnet = _pair(_bert)
    q = tq.quantize_model(tnet, _ids(16), min_size=1)
    assert not any(isinstance(l, tq.QuantizedTensor)
                   for l in tree_leaves(q.qparams["bert_0"]))
    assert {n for n, g in q.qparams.items()
            if isinstance(g.get("kernel"), tq.QuantizedTensor)} \
        == {"dense_0", "dense_1"}
    assert q.predict(_ids(5), batch_size=4).shape == (5, 3)


def test_multi_input_calibration_rejected():
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    m = _port_mlp(3)
    x = _mlp_x(8)
    with pytest.raises(ValueError, match="multi-input"):
        tq.quantize_model(m, [x, x])
    with pytest.raises(ValueError, match="multi-input"):
        InferenceModel().from_keras_net(m).optimize(
            "int8", calibration_data=(x, x))


def test_tail_batch_padded():
    m = _port_mlp(6)
    q = tq.quantize_model(m, _mlp_x(64))
    seen = []
    forward = q.forward
    q.forward = lambda x: seen.append(tuple(x.shape)) or forward(x)
    x = _mlp_x(100, 1)
    out = q.predict(x, batch_size=32)  # 3 full + a tail of 4
    assert out.shape == (100, 4)
    assert seen == [(32, 32)] * 4
    # rows are independent: the padded tail equals the same rows alone
    np.testing.assert_array_equal(out[96:], q.predict(x[96:], batch_size=4))


def test_from_keras_net_resets():
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    m = _port_mlp(7)
    x = _mlp_x(32)
    im = InferenceModel().from_keras_net(m)
    ref = im.predict(x)
    im.optimize("int8", calibration_data=_mlp_x(32, 1))
    im.from_keras_net(m)  # reload: full f32 again
    assert im._int8_model is None and not im._quantized
    np.testing.assert_allclose(im.predict(x), ref, atol=1e-6)
    im.optimize("bf16")
    im.from_keras_net(m)
    np.testing.assert_allclose(im.predict(x), ref, atol=1e-6)
    with pytest.raises(ValueError, match="unknown precision"):
        im.optimize("fp16", calibration_data=x)
    np.testing.assert_allclose(im.predict(x), ref, atol=1e-6)


def test_conv_target_raises(monkeypatch):
    """A ``Convolution2D`` is a calibration target: its kernel is
    quantized and its forward goes through ``_int8_conv`` once a forward;
    a layer with a kernel that is neither ``Dense`` nor a ``_ConvND`` is no
    target (no scale, a float kernel, no hook), as in the reference."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Layer, Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    class Mix(Layer):
        def build(self, input_shape):
            self.add_weight("kernel", (int(input_shape[-1]), 64),
                            "glorot_uniform")

        def call(self, params, inputs, state=None, training=False,
                 rng=None):
            return inputs @ params["kernel"]

        def compute_output_shape(self, input_shape):
            return tuple(input_shape[:-1]) + (64,)

    m = Sequential()
    m.add(tl.Convolution2D(16, 3, 3, border_mode="same", activation="relu",
                           input_shape=(6, 6, 8), name="conv_0"))
    m.add(Mix(name="mix_0"))
    m.add(tl.Flatten())
    m.add(tl.Dense(3, activation="softmax", name="dense_0"))
    m.build_params(rng=torch.Generator().manual_seed(0), device="cpu")
    assert [l.name for l in tq._target_layers(m)] == ["conv_0", "dense_0"]
    x = np.random.default_rng(0).normal(size=(8, 6, 6, 8)).astype(
        np.float32)
    q = tq.quantize_model(m, x)
    assert sorted(q.act_scales) == ["conv_0", "dense_0"]
    assert isinstance(q.qparams["conv_0"]["kernel"], tq.QuantizedTensor)
    assert not isinstance(q.qparams["mix_0"]["kernel"], tq.QuantizedTensor)
    # the (Cout, K) copy the kernel reads: each tap's 8 channels
    # zero-padded to 16
    assert q.weights_t["conv_0"].shape == (16, 3 * 3 * 16)
    calls = []
    conv = tq._int8_conv
    monkeypatch.setattr(tq, "_int8_conv",
                        lambda *a: calls.append(a[0].name) or conv(*a))
    out = q.predict(x, batch_size=8)
    assert calls == ["conv_0"]
    assert out.shape == (8, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)