"""The port's ``LocalEstimator`` against the reference's.

From the same weights both packages fit the same MLP for two epochs
(``fit(x, y, epochs=2, seed=7)``): each epoch's last loss within 1e-5
relative and the parameters within 1e-3 relative L2 per leaf (the fit
twins' tolerances), ``evaluate`` within 1e-5; and the port's K=4
dispatch gives its K=1 history and weights bit for bit (on one thread),
as the reference's ``test_local_k4_bitwise_equal_to_k1`` pins.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.common.utils import tree_leaves
from analytics_zoo_tpu_torch.pipeline.estimator import LocalEstimator


@pytest.fixture(autouse=True)
def _restore():
    saved = engine._CONTEXT, torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    engine._CONTEXT = saved[0]
    torch.set_num_threads(saved[1])


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    return x, (x[:, 0] + x[:, 1] > 0).astype(np.int32)


def _pair():
    import jax

    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jkeras
    from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
    from analytics_zoo_tpu_torch.convert import params_from_jax
    from analytics_zoo_tpu_torch.pipeline.api import keras as tkeras
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers

    jax_init(seed=1)
    init_zoo_context(seed=1, device="cpu")
    nets = []
    for keras, layers in ((jkeras, jlayers), (tkeras, tlayers)):
        m = keras.Sequential()
        m.add(layers.Dense(16, activation="relu", input_shape=(8,)))
        m.add(layers.Dense(4, activation="softmax"))
        m.build_params()
        nets.append(m)
    jnet, tnet = nets
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    return jnet, tnet


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_local_estimator_matches_the_reference(optimizer):
    import jax

    from analytics_zoo_tpu.common import engine as jax_engine
    from analytics_zoo_tpu.pipeline.estimator import (
        LocalEstimator as JaxLocal,
    )

    saved = jax_engine._CONTEXT
    try:
        jnet, tnet = _pair()
        x, y = _data()
        loss = "sparse_categorical_crossentropy"
        je = JaxLocal(jnet, loss, optimizer, metrics=["accuracy"])
        te = LocalEstimator(tnet, loss, optimizer, metrics=["accuracy"])
        je.fit(x, y, batch_size=32, epochs=2, seed=7)
        te.fit(x, y, batch_size=32, epochs=2, seed=7)
        assert len(te.history) == 2
        np.testing.assert_allclose(te.history, je.history, rtol=1e-5)
        for a, b in zip(tree_leaves(tnet.params),
                        jax.tree_util.tree_leaves(jnet.params)):
            b = np.asarray(b, np.float64)
            assert np.linalg.norm(a.numpy() - b) / np.linalg.norm(b) < 1e-3
        got, want = te.evaluate(x, y), je.evaluate(x, y)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-5), key
    finally:
        jax_engine._CONTEXT = saved


def test_local_k4_bitwise_equal_to_k1():
    """192 samples / batch 32 = 6 steps an epoch: one 4-step dispatch and
    two tail steps at K=4."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense,
        Dropout,
    )

    x, y = _data()
    x, y = x[:192], y[:192]

    def run(k):
        init_zoo_context(seed=1, device="cpu")
        m = Sequential()
        m.add(Dense(16, activation="relu", input_shape=(8,)))
        m.add(Dropout(0.3))
        m.add(Dense(4, activation="softmax"))
        m.build_params()
        est = LocalEstimator(m, "sparse_categorical_crossentropy", "adam")
        est.fit(x, y, batch_size=32, epochs=2, seed=7, steps_per_dispatch=k)
        return est.history, m.params

    h1, p1 = run(1)
    h4, p4 = run(4)
    assert h1 == h4
    for a, b in zip(tree_leaves(p1), tree_leaves(p4), strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match=">= 1"):
        LocalEstimator(Sequential(), "mse", "sgd").fit(
            x, y, steps_per_dispatch=0)
