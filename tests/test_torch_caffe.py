"""The port's Caffe loader against the JAX package's.

``parse_prototxt`` and ``parse_caffemodel`` give equal results in both
packages (modern and V1 formats), and the same prototxt and caffemodel
bytes run through both ``CaffeNet``s within 1e-5, outputs and gradients:
grouped convolution, LRN across and within channels, MAX and AVE pooling
with caffe's ceil rounding and padding, BatchNorm with its scale factor,
Scale, PReLU, Eltwise, Concat, Split, InnerProduct and Softmax.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models import caffe as jcaffe
from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.models.caffe import (
    CaffeNet,
    load_caffe,
    normalize_v1_layer,
    parse_caffemodel,
    parse_prototxt,
)
from analytics_zoo_tpu_torch.pipeline.api.onnx.proto import (
    _put_bytes,
    _put_varint,
)

TOL = 1e-5
rng0 = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _cpu():
    init_zoo_context(seed=42, device="cpu")


def encode_blob(arr, legacy=False):
    out = bytearray()
    if legacy:  # num/channels/height/width fields
        dims = (1,) * (4 - arr.ndim) + arr.shape
        for f, d in zip((1, 2, 3, 4), dims):
            _put_varint(out, f, d)
    else:
        shape = bytearray()
        for d in arr.shape:
            _put_varint(shape, 1, d)
        _put_bytes(out, 7, bytes(shape))
    _put_bytes(out, 5, np.ascontiguousarray(arr, np.float32).tobytes())
    return bytes(out)


def encode_caffemodel(layer_blobs, v1=False):
    """{layer: [arrays]} -> NetParameter bytes (modern ``layer`` field 100,
    or V1 ``layers`` field 2 with legacy blob dims)."""
    out = bytearray()
    _put_bytes(out, 1, b"net")
    for name, blobs in layer_blobs.items():
        layer = bytearray()
        _put_bytes(layer, 4 if v1 else 1, name.encode())
        if v1:
            _put_varint(layer, 5, 4)
        else:
            _put_bytes(layer, 2, b"Convolution")
        for arr in blobs:
            _put_bytes(layer, 6 if v1 else 7, encode_blob(arr, legacy=v1))
        _put_bytes(out, 2 if v1 else 100, bytes(layer))
    return bytes(out)


PROTOTXT = """
name: "Wide"  # a comment
input: "data"
input_shape { dim: 2 dim: 4 dim: 13 dim: 13 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1 stride: 2
                      group: 2 } }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 3 alpha: 0.001 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "bn1" type: "BatchNorm" bottom: "pool1" top: "bn1"
  batch_norm_param { eps: 1e-5 } }
layer { name: "scale1" type: "Scale" bottom: "bn1" top: "scale1"
  scale_param { bias_term: true } }
layer { name: "prelu" type: "PReLU" bottom: "scale1" top: "scale1" }
layer { name: "split" type: "Split" bottom: "scale1" top: "a" top: "b" }
layer { name: "norm2" type: "LRN" bottom: "a" top: "norm2"
  lrn_param { local_size: 3 alpha: 0.01 beta: 0.75
              norm_region: WITHIN_CHANNEL } }
layer { name: "elu" type: "ELU" bottom: "b" top: "elu" }
layer { name: "sum" type: "Eltwise" bottom: "norm2" bottom: "elu" top: "s"
  eltwise_param { operation: SUM coeff: 1.0 coeff: 0.5 } }
layer { name: "mx" type: "Eltwise" bottom: "s" bottom: "a" top: "m"
  eltwise_param { operation: MAX } }
layer { name: "cat" type: "Concat" bottom: "m" bottom: "s" top: "c" }
layer { name: "pool2" type: "Pooling" bottom: "c" top: "pool2"
  pooling_param { pool: AVE kernel_size: 2 stride: 2 pad: 1 } }
layer { name: "pw" type: "Power" bottom: "pool2" top: "pw"
  power_param { power: 2 scale: 0.5 shift: 1.0 } }
layer { name: "drop" type: "Dropout" bottom: "pw" top: "pw" }
layer { name: "fc" type: "InnerProduct" bottom: "pw" top: "fc"
  inner_product_param { num_output: 5 } }
layer { name: "relu" type: "ReLU" bottom: "fc" top: "fc"
  relu_param { negative_slope: 0.1 } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc" top: "loss" }
layer { name: "d2" type: "Dropout" bottom: "fc" top: "fc"
        include { phase: TRAIN } }
"""


def _blobs():
    f = lambda *s, scale=1.0: (rng0.normal(size=s) * scale).astype(  # noqa
        np.float32)
    return {
        "conv1": [f(6, 2, 3, 3, scale=0.3), f(6)],
        "bn1": [f(6, scale=0.1), rng0.uniform(0.5, 1.5, 6).astype(
            np.float32), np.asarray([2.0], np.float32)],
        "scale1": [rng0.uniform(0.5, 1.5, 6).astype(np.float32), f(6)],
        "prelu": [np.full(6, 0.2, np.float32)],
        "fc": [f(5, 12 * 2 * 2, scale=0.1), f(5)],
    }


def _jax_out_and_grads(def_text, blobs, x):
    net = jcaffe.CaffeNet(jcaffe.parse_prototxt(def_text),
                          jcaffe.parse_caffemodel(encode_caffemodel(blobs)))
    net.ensure_built(x.shape[1:])
    params = net.init_params(jax.random.PRNGKey(0))

    def f(p):
        return net.apply(p, jnp.asarray(x))[0]

    out, vjp = jax.vjp(f, params)
    probe = jnp.asarray(np.random.default_rng(1).normal(
        size=np.shape(out)).astype(np.float32))
    return np.asarray(out), {k: np.asarray(v)
                             for k, v in vjp(probe)[0].items()}


def _port_out_and_grads(def_text, blobs, x):
    net = CaffeNet(parse_prototxt(def_text),
                   parse_caffemodel(encode_caffemodel(blobs)))
    net.ensure_built(x.shape[1:])
    params = {k: v.requires_grad_(True) for k, v in
              net.init_params(torch.Generator()).items()}
    out, _ = net.apply(params, torch.from_numpy(x))
    probe = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(out.shape)).astype(np.float32))
    grads = torch.autograd.grad((out * probe).sum(), list(params.values()))
    return out.detach().numpy(), {k: g.numpy() for k, g in
                                  zip(params, grads)}


def test_parsers_match_reference():
    assert parse_prototxt(PROTOTXT) == jcaffe.parse_prototxt(PROTOTXT)
    assert parse_prototxt(V1_PROTOTXT) == jcaffe.parse_prototxt(V1_PROTOTXT)
    blobs = _blobs()
    for v1 in (False, True):
        data = encode_caffemodel(blobs, v1=v1)
        got, want = parse_caffemodel(data), jcaffe.parse_caffemodel(data)
        assert set(got) == set(want) == set(blobs)
        for k in want:
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                assert a.shape == b.shape and a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for t in (4, 14, "POOLING", "TANH", "Convolution"):
        assert normalize_v1_layer({"type": t}) == \
            jcaffe.normalize_v1_layer({"type": t})


def test_caffe_net_matches_reference():
    x = rng0.normal(size=(2, 4, 13, 13)).astype(np.float32)
    blobs = _blobs()
    jo, jg = _jax_out_and_grads(PROTOTXT, blobs, x)
    po, pg = _port_out_and_grads(PROTOTXT, blobs, x)
    assert po.shape == jo.shape == (2, 5)
    np.testing.assert_allclose(po, jo, atol=TOL, rtol=TOL)
    assert set(pg) == set(jg)
    for k in jg:
        scale = max(1.0, float(np.abs(jg[k]).max()))
        np.testing.assert_allclose(pg[k], jg[k], atol=TOL * scale, rtol=TOL,
                                   err_msg=k)


V1_PROTOTXT = """
name: "V1Net"
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 stride: 1 } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 } }
layers { name: "flat" type: FLATTEN bottom: "pool1" top: "flat" }
layers { name: "fc" type: INNER_PRODUCT bottom: "flat" top: "fc"
  inner_product_param { num_output: 5 } }
layers { name: "prob" type: SOFTMAX bottom: "fc" top: "prob" }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "fc" top: "loss" }
layers { name: "acc" type: ACCURACY bottom: "prob" top: "acc" }
"""


def test_v1_net_from_files_matches_reference(tmp_path):
    blobs = {"conv1": [(rng0.normal(size=(4, 3, 3, 3)) * 0.3).astype(
        np.float32), rng0.normal(size=(4,)).astype(np.float32)],
        "fc": [(rng0.normal(size=(5, 4 * 4 * 4)) * 0.1).astype(np.float32),
               rng0.normal(size=(5,)).astype(np.float32)]}
    proto_path = tmp_path / "v1.prototxt"
    proto_path.write_text(V1_PROTOTXT)
    model_path = tmp_path / "v1.caffemodel"
    model_path.write_bytes(encode_caffemodel(blobs, v1=True))
    x = rng0.normal(size=(2, 3, 8, 8)).astype(np.float32)
    jnet = jcaffe.load_caffe(str(proto_path), str(model_path))
    jnet.ensure_built((3, 8, 8))
    want = np.asarray(jnet.apply(jnet.init_params(jax.random.PRNGKey(0)),
                                 jnp.asarray(x))[0])
    from analytics_zoo_tpu_torch.pipeline.api.net import Net

    net = Net.load_caffe(str(proto_path), str(model_path))
    assert net.output_names == ["prob"]
    net.ensure_built((3, 8, 8))
    got = net.apply(net.init_params(torch.Generator()),
                    torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_frozen_net_and_refusals():
    proto = """
input: "data"
input_shape { dim: 1 dim: 1 dim: 4 dim: 4 }
layer { name: "p" type: "Pooling" bottom: "data" top: "p"
        pooling_param { pool: STOCHASTIC kernel_size: 2 stride: 2 } }
"""
    net = CaffeNet(parse_prototxt(proto))
    net.ensure_built((1, 4, 4))
    with pytest.raises(NotImplementedError, match="STOCHASTIC"):
        net.apply({}, torch.zeros(1, 1, 4, 4))
    with pytest.raises(NotImplementedError, match="SPPLayer"):
        CaffeNet(parse_prototxt(proto.replace('"Pooling"', '"SPPLayer"')))
    net = CaffeNet(parse_prototxt(PROTOTXT))
    net.ensure_built((4, 13, 13))
    with pytest.raises(ValueError, match="caffemodel"):
        net.apply({}, torch.zeros(1, 4, 13, 13))
    frozen = CaffeNet(parse_prototxt(PROTOTXT),
                      parse_caffemodel(encode_caffemodel(_blobs())),
                      trainable=False)
    frozen.ensure_built((4, 13, 13))
    assert frozen.stateful and not frozen._weight_specs
    assert "conv1/blob0" in frozen.init_state()
    x = rng0.normal(size=(2, 4, 13, 13)).astype(np.float32)
    out, _ = frozen.apply({}, torch.from_numpy(x),
                          state=frozen.init_state())
    np.testing.assert_allclose(out.numpy().sum(-1), 1.0, atol=1e-5)


def test_caffe_net_finetunes_in_sequential(tmp_path):
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential

    m = Sequential()
    m.add(CaffeNet(parse_prototxt(PROTOTXT),
                   parse_caffemodel(encode_caffemodel(_blobs()))))
    x = rng0.normal(size=(8, 4, 13, 13)).astype(np.float32)
    y = np.random.default_rng(3).integers(0, 5, 8).astype(np.int32)
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    m.fit(x, y, batch_size=8, nb_epoch=4)
    losses = [v for _, v in m._estimator.loss_log]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert set(m.params[m.layers[0].name]) >= {"conv1/blob0", "fc/blob1"}
