"""The port's Net facade, TorchNet, TorchCriterion and TFNet against the
JAX package's.

The same torch module (or tf.keras model) runs inside both packages'
layers: outputs and input gradients agree within 1e-5.  In the port a
TorchNet runs on the net's device inside the step, so a captured predict
replays it; a TFNet runs on the host, so a net holding one runs its steps
uncaptured, under labels ending in ``_host``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api import net as jnet
from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.common.compile_cache import (
    compile_stats,
    reset_compile_stats,
)
from analytics_zoo_tpu_torch.parallel.plan import host_bound
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.pipeline.api.net import (
    Net,
    TFNet,
    TorchCriterion,
    TorchNet,
    import_state_dict,
)

TOL = 1e-5
rng0 = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _cpu():
    init_zoo_context(seed=42, device="cpu")


def _module():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                               torch.nn.Linear(5, 3))


def _port_out_and_input_grad(layer, x):
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = layer.apply({}, xt)
    (g,) = torch.autograd.grad((out ** 2).sum(), xt)
    return out.detach().numpy(), g.numpy()


def _jax_out_and_input_grad(layer, x):
    out, _ = layer.apply({}, jnp.asarray(x))
    g = jax.grad(lambda xx: jnp.sum(layer.call({}, xx) ** 2))(jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


def test_torchnet_output_and_input_gradient_match_reference():
    mod = _module()
    x = rng0.normal(size=(4, 6)).astype(np.float32)
    ref = jnet.TorchNet.from_pytorch(mod, input_shape=(6,))
    ref.ensure_built((6,))
    port = TorchNet.from_pytorch(mod, input_shape=(6,))
    port.ensure_built((6,))
    assert port.compute_output_shape((None, 6)) == (None, 3)
    jo, jg = _jax_out_and_input_grad(ref, x)
    po, pg = _port_out_and_input_grad(port, x)
    np.testing.assert_allclose(po, jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pg, jg, atol=TOL, rtol=TOL)
    # frozen: no parameter of the module takes a gradient
    assert not any(p.requires_grad for p in mod.parameters())


def test_torchnet_in_sequential_trains_only_the_native_layers(tmp_path):
    mod = _module()
    m = Sequential()
    m.add(TorchNet.from_pytorch(mod, input_shape=(6,)))
    m.add(Dense(2, activation="softmax"))
    assert not host_bound(m)
    x = rng0.normal(size=(16, 6)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    m.fit(x, y, batch_size=16, nb_epoch=3)
    assert list(m.params) == ["dense_0"]
    for k, v in mod.state_dict().items():
        assert torch.equal(v, before[k])
    out = m.predict(x, batch_size=8)
    with torch.no_grad():
        h = mod(torch.from_numpy(x))
        p = m.params["dense_0"]
        want = torch.softmax(h @ p["kernel"] + p["bias"], -1).numpy()
    np.testing.assert_allclose(out, want, atol=TOL)
    # TorchScript round trip through the facade
    path = str(tmp_path / "m.pt")
    m.layers[0].save(path)
    loaded = Net.load_torch(path, input_shape=(6,))
    loaded.ensure_built((6,))
    np.testing.assert_allclose(
        loaded.apply({}, torch.from_numpy(x))[0].numpy(),
        h.numpy(), atol=TOL)


def test_torch_criterion_matches_reference():
    x = rng0.normal(size=(5, 3)).astype(np.float32)
    y = rng0.normal(size=(5, 3)).astype(np.float32)
    for reduction in ("mean", "none"):
        loss_fn = torch.nn.MSELoss(reduction=reduction)
        ref = jnet.TorchCriterion.from_pytorch(loss_fn)
        port = TorchCriterion.from_pytorch(loss_fn)
        jv, jg = jax.value_and_grad(
            lambda p: ref(jnp.asarray(y), p))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        pv = port.mean(torch.from_numpy(y), xt)
        (pg,) = torch.autograd.grad(pv, xt)
        np.testing.assert_allclose(pv.item(), float(jv), rtol=TOL)
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=TOL)
    with pytest.raises(NotImplementedError, match="sample_weight"):
        port.mean(torch.from_numpy(y), torch.from_numpy(x),
                  sample_weight=torch.ones(5))


def test_import_state_dict_matches_reference():
    from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSeq
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense

    lin = torch.nn.Linear(4, 3)
    mapping = [("dense_0/kernel", "weight", lambda a: a.T),
               ("dense_0/bias", "bias")]
    jm = JSeq()
    jm.add(JDense(3, input_shape=(4,)))
    jp = jnet.import_state_dict(jm, lin.state_dict(), mapping)
    m = Sequential()
    m.add(Dense(3, input_shape=(4,)))
    pp = import_state_dict(m, lin.state_dict(), mapping)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(pp["dense_0"][k].numpy(),
                                      np.asarray(jp["dense_0"][k]))
    with pytest.raises(ValueError, match="shape"):
        import_state_dict(m, lin.state_dict(), [("dense_0/kernel",
                                                 "weight")])


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def test_tfnet_matches_reference_and_runs_uncaptured(tf, tmp_path):
    km = tf.keras.Sequential([tf.keras.layers.Dense(4, activation="tanh"),
                              tf.keras.layers.Dense(2)])
    km.build((None, 6))
    x = rng0.normal(size=(8, 6)).astype(np.float32)
    ref = jnet.TFNet.from_keras(km, input_shape=(6,))
    ref.ensure_built((6,))
    port = TFNet.from_keras(km, input_shape=(6,))
    port.ensure_built((6,))
    jo, jg = _jax_out_and_input_grad(ref, x)
    po, pg = _port_out_and_input_grad(port, x)
    np.testing.assert_allclose(po, jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pg, jg, atol=TOL, rtol=TOL)

    # a net holding a TFNet: every step uncaptured, under its _host label
    m = Sequential()
    m.add(TFNet.from_keras(km, input_shape=(6,)))
    m.add(Dense(2, activation="softmax"))
    assert host_bound(m)
    reset_compile_stats()
    y = (x[:, 0] > 0).astype(np.int32)
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    m.fit(x, y, batch_size=8, nb_epoch=1)
    m.evaluate(x, y, batch_size=8)
    m.predict(x, batch_size=8)
    labels = set(compile_stats())
    assert {"train_step_host", "eval_step_host",
            "predict_step_host"} <= labels
    assert not labels & {"train_step", "eval_step", "predict_step"}
    for step in m._estimator._steps.values():
        assert not step.capture
    assert not m._predict_fn[1].capture

    # a SavedModel through the facade
    d = str(tmp_path / "sm")

    @tf.function(input_signature=[tf.TensorSpec([None, 6], tf.float32)])
    def serve(xx):
        return km(xx)

    tf.saved_model.save(km, d, signatures=serve)
    loaded = Net.load_tf(d, input_shape=(6,))
    loaded.ensure_built((6,))
    np.testing.assert_allclose(
        loaded.apply({}, torch.from_numpy(x))[0].numpy(), km(x).numpy(),
        atol=TOL)
