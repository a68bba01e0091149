"""The port's ONNX codec, loader and exporter against the JAX package's.

The same bytes go through both packages' ``load_onnx``; the outputs (and
the gradients of a fixed projection of them) agree within 1e-5.  The
exporter's bytes for the same weights equal the JAX package's byte for
byte (LeNet-5 and a residual graph), and the wire codec writes the same
bytes for the same model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.onnx import load_onnx as jax_load
from analytics_zoo_tpu.pipeline.api.onnx import proto as jproto
from analytics_zoo_tpu.pipeline.api.onnx.export import (
    export_onnx as jax_export,
)
from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.pipeline.api.onnx import (
    MAPPERS,
    OnnxNet,
    export_onnx,
    load_onnx,
)
from analytics_zoo_tpu_torch.pipeline.api.onnx import proto

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    init_zoo_context(seed=42, device="cpu")


def _graph(nodes, inputs, outputs, inits, opset=13):
    g = proto.Graph(name="g", nodes=nodes, initializers=inits,
                    inputs=[proto.ValueInfo(n, s, proto.FLOAT)
                            for n, s in inputs],
                    outputs=[proto.ValueInfo(n, s, proto.FLOAT)
                             for n, s in outputs])
    return proto.encode_model(proto.Model(opset=opset, graph=g))


def N(op, ins, outs, **attrs):  # noqa: N802
    return proto.Node(op_type=op, inputs=list(ins), outputs=list(outs),
                      attrs=attrs)


def _jax_run(data, xs, trainable=True):
    """(outputs, grads of sum(out * probe) over the float params)."""
    net = jax_load(data, trainable=trainable)
    net.ensure_built(tuple(np.shape(xs[0]))[1:])
    params = net.init_params(jax.random.PRNGKey(0))
    state = net.init_state() or None
    arrs = [jnp.asarray(x) for x in xs]
    arg = arrs if len(arrs) > 1 else arrs[0]

    def f(p):
        out, _ = net.apply(p, arg, state=state)
        return out

    out, vjp = jax.vjp(f, params)
    probe = jnp.asarray(np.random.default_rng(1).normal(
        size=np.shape(out)).astype(np.float32))
    grads = vjp(probe)[0] if params else {}
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def _port_run(data, xs, trainable=True):
    net = load_onnx(data, trainable=trainable)
    net.ensure_built(tuple(np.shape(xs[0]))[1:])
    params = {k: v.requires_grad_(True) for k, v in
              net.init_params(torch.Generator()).items()}
    state = net.init_state() or None
    arrs = [torch.from_numpy(np.asarray(x)) for x in xs]
    out, _ = net.apply(params, arrs if len(arrs) > 1 else arrs[0],
                       state=state)
    probe = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(out.shape)).astype(np.float32))
    grads = {}
    if params:
        g = torch.autograd.grad((out * probe).sum(), list(params.values()),
                                allow_unused=True)
        grads = {k: (np.zeros(tuple(v.shape), np.float32) if gi is None
                     else gi.numpy())
                 for (k, v), gi in zip(params.items(), g)}
    return out.detach().numpy(), grads


def _same(data, xs, trainable=True):
    jo, jg = _jax_run(data, xs, trainable)
    po, pg = _port_run(data, xs, trainable)
    np.testing.assert_allclose(po, jo, atol=TOL, rtol=TOL)
    assert set(pg) == set(jg)
    for k in jg:
        scale = max(1.0, float(np.abs(jg[k]).max()))
        np.testing.assert_allclose(pg[k], jg[k], atol=TOL * scale, rtol=TOL)
    return po


rng0 = np.random.default_rng(0)


def _f32(*shape, scale=1.0):
    return (rng0.normal(size=shape) * scale).astype(np.float32)


def test_codec_bytes_and_decode_match_reference():
    w = _f32(4, 3)
    inits = {"w": w, "shape": np.asarray([1, -1], np.int64)}
    nodes = [N("MatMul", ["x", "w"], ["y"]),
             N("LeakyRelu", ["y"], ["z"], alpha=0.2),
             N("Transpose", ["z"], ["t"], perm=[1, 0])]
    port = _graph(nodes, [("x", (None, 4))], [("t", (3, None))], inits)
    ref = jproto.encode_model(jproto.Model(graph=jproto.Graph(
        name="g",
        nodes=[jproto.Node(op_type=n.op_type, inputs=n.inputs,
                           outputs=n.outputs, attrs=n.attrs) for n in nodes],
        initializers=inits,
        inputs=[jproto.ValueInfo("x", (None, 4), jproto.FLOAT)],
        outputs=[jproto.ValueInfo("t", (3, None), jproto.FLOAT)])))
    assert port == ref
    m, r = proto.decode_model(port), jproto.decode_model(port)
    assert [n.attrs for n in m.graph.nodes] == [n.attrs for n in r.graph.nodes]
    assert m.graph.inputs[0].shape == r.graph.inputs[0].shape == (None, 4)
    np.testing.assert_array_equal(m.graph.initializers["w"], w)
    assert len(MAPPERS) == 59


def _convnet():
    nodes = [
        N("Conv", ["x", "w1", "b1"], ["c1"], pads=[1, 1, 1, 1],
          strides=[1, 1]),
        N("BatchNormalization", ["c1", "g", "be", "mu", "var"], ["bn"],
          epsilon=1e-5),
        N("Relu", ["bn"], ["r1"]),
        N("LRN", ["r1"], ["lrn"], size=3, alpha=1e-3, beta=0.75, bias=1.0),
        N("MaxPool", ["lrn"], ["p1"], kernel_shape=[3, 3], strides=[2, 2],
          ceil_mode=1),
        N("Conv", ["p1", "w2"], ["c2"], group=2, auto_pad="SAME_LOWER",
          strides=[2, 2]),
        N("AveragePool", ["c2"], ["p2"], kernel_shape=[2, 2],
          strides=[1, 1], pads=[0, 0, 1, 1]),
        N("ConvTranspose", ["p2", "wt", "bt"], ["ct"], strides=[2, 2],
          pads=[1, 0, 0, 1], output_padding=[1, 1]),
        N("GlobalAveragePool", ["ct"], ["gp"]),
        N("Flatten", ["gp"], ["f"], axis=1),
        N("Gemm", ["f", "wf", "bf"], ["logits"], transB=1, alpha=0.5),
        N("Softmax", ["logits"], ["out"], axis=-1),
    ]
    inits = {"w1": _f32(4, 3, 3, 3, scale=0.3), "b1": _f32(4),
             "g": _f32(4) + 1, "be": _f32(4),
             "mu": _f32(4, scale=0.1),
             "var": np.abs(_f32(4)) + 0.5,
             "w2": _f32(6, 2, 3, 3, scale=0.3),
             "wt": _f32(6, 5, 3, 3, scale=0.3), "bt": _f32(5),
             "wf": _f32(7, 5), "bf": _f32(7)}
    return _graph(nodes, [("x", (None, 3, 11, 11))], [("out", (None, 7))],
                  inits)


def test_convnet_matches_reference():
    data = _convnet()
    out = _same(data, [_f32(2, 3, 11, 11)])
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


def test_elementwise_shape_and_reduce_ops_match_reference():
    nodes = [
        N("Add", ["a", "b"], ["s"]), N("Mul", ["s", "k"], ["m"]),
        N("Sub", ["m", "b"], ["d"]), N("Div", ["d", "two"], ["q"]),
        N("Abs", ["q"], ["ab"]), N("Sqrt", ["ab"], ["sq"]),
        N("Exp", ["sq"], ["e"]), N("Log", ["e"], ["lg"]),
        N("Neg", ["lg"], ["ng"]), N("Sigmoid", ["ng"], ["sg"]),
        N("Tanh", ["q"], ["th"]), N("Elu", ["q"], ["el"], alpha=0.7),
        N("HardSigmoid", ["q"], ["hs"]), N("Softplus", ["q"], ["sp"]),
        N("Erf", ["q"], ["ef"]), N("Reciprocal", ["two"], ["rc"]),
        N("Pow", ["sg", "two"], ["pw"]),
        N("Clip", ["th", "lo", "hi"], ["cl"]),
        N("Max", ["cl", "el", "hs"], ["mx"]),
        N("Min", ["mx", "sp"], ["mn"]),
        N("Sum", ["mn", "ef", "pw", "rc"], ["sm"]),
        N("Concat", ["sm", "a"], ["cat"], axis=1),
        N("Slice", ["cat", "st", "en", "ax"], ["sl"]),
        N("Pad", ["sl", "pads"], ["pd"], mode="constant"),
        N("Unsqueeze", ["pd", "uax"], ["us"]),
        N("Squeeze", ["us", "uax"], ["sq2"]),
        N("Reshape", ["sq2", "shape"], ["rs"]),
        N("Transpose", ["rs"], ["tr"], perm=[0, 2, 1]),
        N("ReduceMean", ["tr"], ["rm"], axes=[1], keepdims=0),
        N("ReduceMax", ["tr"], ["rx"], axes=[2], keepdims=1),
        N("ReduceSum", ["rx"], ["rsum"], axes=[1, 2], keepdims=0),
        N("Split", ["rm", "parts"], ["sa", "sb"], axis=1),
        N("Gather", ["sa", "idx"], ["ga"], axis=1),
        N("MatMul", ["ga", "wm"], ["mm"]),
        N("Concat", ["mm", "sb"], ["cat2"], axis=1),
        N("LogSoftmax", ["cat2"], ["ls"], axis=1),
        N("Unsqueeze", ["rsum", "uax1"], ["rsu"]),
        N("Expand", ["rsu", "eshape"], ["ex"]),
        N("Tile", ["ex", "reps"], ["ti"]),
        N("Mul", ["ti", "half"], ["tm"]),
        N("Cast", ["tm"], ["ct"], to=1),
        N("Identity", ["ct"], ["idt"]),
        N("Dropout", ["idt"], ["dr"]),
        N("Add", ["ls", "dr"], ["out"]),
    ]
    inits = {"k": _f32(6), "two": np.asarray(2.0, np.float32),
             "lo": np.asarray(-0.5, np.float32),
             "hi": np.asarray(0.6, np.float32),
             "st": np.asarray([1], np.int64),
             "en": np.asarray([11], np.int64),
             "ax": np.asarray([1], np.int64),
             "pads": np.asarray([0, 1, 0, 1], np.int64),
             "uax": np.asarray([0], np.int64),
             "shape": np.asarray([0, 4, 3], np.int64),
             "parts": np.asarray([3, 1], np.int64),
             "idx": np.asarray([1, -2, 0], np.int64),
             "wm": _f32(3, 4),
             "uax1": np.asarray([1], np.int64),
             "eshape": np.asarray([2, 1], np.int64),
             "reps": np.asarray([1, 5], np.int64),
             "half": np.asarray(0.5, np.float32)}
    data = _graph(nodes, [("a", (None, 6)), ("b", (None, 6))],
                  [("out", (None, 5))], inits)
    _same(data, [_f32(2, 6), _f32(2, 6)])


def test_pre13_softmax_constant_and_argmax_match_reference():
    nodes = [N("Constant", [], ["c"], value=_f32(2, 3)),
             N("Add", ["x", "c"], ["s"]),
             N("Softmax", ["s"], ["sm"], axis=1),
             N("ArgMax", ["sm"], ["am"], axis=2, keepdims=0),
             N("ReduceMin", ["sm"], ["mn"], axes=[2], keepdims=1),
             N("ReduceProd", ["sm"], ["pr"], axes=[1], keepdims=1),
             N("Add", ["mn", "pr"], ["out"])]
    data = _graph(nodes, [("x", (None, 2, 3))], [("out", (None, 2, 1))],
                  {}, opset=11)
    x = [_f32(3, 2, 3)]
    _same(data, x)
    jn, pn = jax_load(data), load_onnx(data)
    jn.ensure_built((2, 3))
    pn.ensure_built((2, 3))
    env_j = np.asarray(jn.apply({}, jnp.asarray(x[0]))[0])
    env_p = pn.apply({}, torch.from_numpy(x[0]))[0].numpy()
    np.testing.assert_allclose(env_p, env_j, atol=TOL)


def test_frozen_net_keeps_initializers_in_state():
    data = _convnet()
    po = _same(data, [_f32(2, 3, 11, 11)], trainable=False)
    net = load_onnx(data, trainable=False)
    net.ensure_built((3, 11, 11))
    assert not net._weight_specs and net.stateful
    assert set(net.init_state()) == {"w1", "b1", "g", "be", "mu", "var",
                                     "w2", "wt", "bt", "wf", "bf"}
    assert po.shape == (2, 7)


def test_unsupported_op_reports_cleanly():
    data = _graph([N("Einsum", ["x"], ["y"])], [("x", (None, 2))],
                  [("y", (None, 2))], {})
    with pytest.raises(NotImplementedError, match="Einsum"):
        load_onnx(data)


def _lenet_pair():
    from analytics_zoo_tpu.models.lenet import build_lenet as jlenet
    from analytics_zoo_tpu_torch.models.lenet import build_lenet

    jnet = jlenet(classes=10)
    jnet.build_params(jax.random.PRNGKey(5))
    net = build_lenet(classes=10)
    return jnet, net, (2, 28, 28, 1)


def _residual_pair():
    def build(pkg):
        keras = __import__(f"{pkg}.pipeline.api.keras", fromlist=["x"])
        L = keras.layers
        inp = keras.Input(shape=(8, 8, 3), name="img")
        a = L.Convolution2D(4, 3, 3, border_mode="same")(inp)
        a = L.BatchNormalization()(a)
        b = L.Convolution2D(4, 1, 1, border_mode="same",
                            subsample=(1, 1))(inp)
        s = L.Merge(mode="sum")([a, b])
        s = L.Activation("relu")(s)
        s = L.MaxPooling2D((2, 2), border_mode="same")(s)
        c = L.AveragePooling2D((2, 2), strides=(1, 1),
                               border_mode="same")(s)
        m = L.Merge(mode="concat", concat_axis=-1)([s, c])
        f = L.Flatten()(m)
        f = L.Dropout(0.3)(f)
        out = L.Dense(3, activation="softmax")(f)
        return keras.Model(inp, out)

    jnet = build("analytics_zoo_tpu")
    jnet.build_params(jax.random.PRNGKey(3))
    # moving statistics away from (0, 1), as after training
    st = jax.tree_util.tree_map(np.asarray, jnet.state)
    for name, s in st.items():
        if "moving_mean" in s:
            s["moving_mean"] = _f32(*s["moving_mean"].shape, scale=0.1)
            s["moving_var"] = np.abs(_f32(*s["moving_var"].shape)) + 0.5
    jnet.state = st
    return jnet, build("analytics_zoo_tpu_torch"), (2, 8, 8, 3)


@pytest.mark.parametrize("make", [_lenet_pair, _residual_pair],
                         ids=["lenet5", "residual"])
def test_export_bytes_equal_reference(make):
    jnet, net, xshape = make()
    net.build_params(device="cpu")
    net.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jnet.params), "cpu")
    net.state = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jnet.state), "cpu")
    ref = jax_export(jnet)
    got = export_onnx(net)
    assert got == ref
    # the exported graph reloads in the port and reproduces the net
    x = _f32(*xshape)
    want = net.predict(x, batch_size=2)
    loaded = load_onnx(got)
    loaded.ensure_built(tuple(x.transpose(0, 3, 1, 2).shape[1:]))
    out, _ = loaded.apply(loaded.init_params(torch.Generator()),
                          torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)


def test_onnx_net_finetunes_and_predicts_in_sequential(tmp_path):
    from analytics_zoo_tpu_torch.common.compile_cache import compile_stats
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.net import Net

    path = tmp_path / "m.onnx"
    path.write_bytes(_convnet())
    onnx_net = Net.load_onnx(str(path))
    assert isinstance(onnx_net, OnnxNet)
    m = Sequential()
    m.add(onnx_net)
    x = _f32(16, 3, 11, 11)
    y = np.random.default_rng(2).integers(0, 7, 16).astype(np.int32)
    before = m.predict(x, batch_size=8)
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    m.fit(x, y, batch_size=16, nb_epoch=5)  # one fixed batch an epoch
    after = m.predict(x, batch_size=8)
    assert not np.allclose(before, after)
    losses = [v for _, v in m._estimator.loss_log]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert "predict_step" in compile_stats()
