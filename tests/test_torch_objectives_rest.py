"""The port's losses and metrics against the JAX package's, on the same
seeded numpy inputs.

- every loss of the reference's table (``get_loss`` by each of its
  names, the class-style factories and ``RankHinge``): the per-sample
  values and the gradient of the mean with respect to the predictions
  within ``LOSS_RTOL`` relative to the largest magnitude (f32 on both
  sides; ``log``, ``sqrt`` and the reductions round in their own orders);
- ``MAE``, ``MSE`` and ``AUC``: each batch's statistics with and without
  a padding mask, and the finalized value over two batches, within
  ``METRIC_RTOL`` (AUC's counts are sums of 0/1 and equal; its trapezoid
  runs on the host in float64 in both);
- a binary classifier evaluated with ``["auc", "mae", "mse"]`` through
  each package's ``evaluate`` on the reference's weights.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.pipeline.api.keras import metrics as tm
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as to

LOSS_RTOL = 1e-6
METRIC_RTOL = 1e-6
B, C = 64, 10


@pytest.fixture(autouse=True)
def _restore_contexts():
    saved = engine._CONTEXT
    yield
    engine._CONTEXT = saved
    import analytics_zoo_tpu.common.engine as jax_engine
    jax_engine._CONTEXT = None


def _inputs(name, seed=0):
    """(y_true, y_pred) in the loss's domain: probabilities for the
    cross-entropies and divergences, +-1 targets for the hinges, positive
    rates for Poisson, one-hot targets for the categorical one, integer
    labels for the sparse ones."""
    gen = np.random.default_rng(seed)
    logits = gen.normal(size=(B, C)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = gen.integers(0, C, B).astype(np.int32)
    if name.startswith("sparse"):
        return labels, (logits if "logits" in name else probs)
    if name == "categorical_crossentropy":
        return np.eye(C, dtype=np.float32)[labels], probs
    if name in ("binary_crossentropy", "kullback_leibler_divergence", "kld"):
        u = gen.random((B, C)).astype(np.float32)
        return u, probs if name != "binary_crossentropy" \
            else gen.uniform(0.01, 0.99, (B, C)).astype(np.float32)
    if name == "binary_crossentropy_from_logits":
        return gen.integers(0, 2, (B, C)).astype(np.float32), logits
    if name in ("hinge", "squared_hinge"):
        return np.sign(gen.normal(size=(B, C))).astype(np.float32), logits
    if name == "poisson":
        return gen.poisson(2.0, (B, C)).astype(np.float32), \
            np.exp(logits).astype(np.float32)
    if name in ("mean_squared_logarithmic_error", "msle"):
        return np.abs(logits) * 3, gen.random((B, C)).astype(np.float32) * 3
    if name == "rank_hinge":
        return np.ones((B, 1), np.float32), logits[:, :1]
    return gen.normal(size=(B, C)).astype(np.float32), logits


def _jax_loss_and_grad(fn, y_true, y_pred):
    import jax
    import jax.numpy as jnp

    def mean(p):
        return jnp.mean(fn(jnp.asarray(y_true), p))

    val = fn(jnp.asarray(y_true), jnp.asarray(y_pred))
    return np.asarray(val), np.asarray(jax.grad(mean)(jnp.asarray(y_pred)))


def _torch_loss_and_grad(fn, y_true, y_pred):
    p = torch.from_numpy(y_pred).requires_grad_(True)
    val = fn(torch.from_numpy(y_true), p)
    (grad,) = torch.autograd.grad(val.mean(), p)
    return val.detach().numpy(), grad.numpy()


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * scale


def _reference_losses():
    from analytics_zoo_tpu.pipeline.api.keras import objectives as jo

    return jo


@pytest.mark.parametrize("name", sorted(_reference_losses()._LOSSES))
def test_loss_and_gradient_match_the_reference(name):
    jo = _reference_losses()
    assert sorted(to._LOSSES) == sorted(jo._LOSSES)
    y_true, y_pred = _inputs(name)
    jval, jgrad = _jax_loss_and_grad(jo.get_loss(name), y_true, y_pred)
    loss = to.get_loss(name)
    assert loss.name == name
    tval, tgrad = _torch_loss_and_grad(loss, y_true, y_pred)
    _close(tval, jval, LOSS_RTOL)
    _close(tgrad, jgrad, LOSS_RTOL)


@pytest.mark.parametrize("factory,name", [
    ("MeanSquaredError", "mse"), ("MeanAbsoluteError", "mae"),
    ("BinaryCrossEntropy", "binary_crossentropy"),
    ("CategoricalCrossEntropy", "categorical_crossentropy"),
    ("SparseCategoricalCrossEntropy", "sparse_categorical_crossentropy")])
def test_factories_are_the_named_losses(factory, name):
    jo = _reference_losses()
    loss = getattr(to, factory)()
    assert loss.name == getattr(jo, factory)().name == name
    y_true, y_pred = _inputs(name)
    tval, _ = _torch_loss_and_grad(loss, y_true, y_pred)
    jval, _ = _jax_loss_and_grad(getattr(jo, factory)(), y_true, y_pred)
    _close(tval, jval, LOSS_RTOL)


@pytest.mark.parametrize("margin", [1.0, 0.5])
def test_rank_hinge_class_matches_the_reference(margin):
    jo = _reference_losses()
    gen = np.random.default_rng(2)
    y_pred = gen.normal(size=(B, 1)).astype(np.float32)
    y_true = np.ones((B, 1), np.float32)
    jval, jgrad = _jax_loss_and_grad(jo.RankHinge(margin), y_true, y_pred)
    tval, tgrad = _torch_loss_and_grad(to.RankHinge(margin), y_true, y_pred)
    assert to.RankHinge(margin).name == "rank_hinge"
    _close(tval, jval, LOSS_RTOL)
    _close(tgrad, jgrad, LOSS_RTOL)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        to.get_loss("no_such_loss")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _metric_batch(seed, binary):
    gen = np.random.default_rng(seed)
    if binary:
        y_pred = gen.random((B, 1)).astype(np.float32)
        y_true = (gen.random((B, 1)) < y_pred).astype(np.float32)
    else:
        y_pred = gen.normal(size=(B, 3)).astype(np.float32)
        y_true = gen.normal(size=(B, 3)).astype(np.float32)
    mask = (np.arange(B) < B - 5).astype(np.float32)  # 5 padding rows
    return y_true, y_pred, mask


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", ["mae", "mse", "auc"])
def test_metric_matches_the_reference(name, masked):
    import jax.numpy as jnp

    from analytics_zoo_tpu.pipeline.api.keras import metrics as jm

    jmetric, tmetric = jm.get_metric(name), tm.get_metric(name)
    assert tmetric.name == jmetric.name == name
    assert tmetric.n_stats == jmetric.n_stats
    jsum = tsum = None
    for seed in (0, 1):
        y_true, y_pred, mask = _metric_batch(seed, binary=name == "auc")
        jstats = jmetric.batch_stats(
            jnp.asarray(y_true), jnp.asarray(y_pred),
            mask=jnp.asarray(mask) if masked else None)
        tstats = tmetric.batch_stats(
            torch.from_numpy(y_true), torch.from_numpy(y_pred),
            mask=torch.from_numpy(mask) if masked else None)
        jstats = [np.asarray(s) for s in jstats]
        tstats = [s.numpy() for s in tstats]
        for t, j in zip(tstats, jstats):
            _close(t, j, METRIC_RTOL)
        jsum = jstats if jsum is None else [a + b for a, b in
                                            zip(jsum, jstats)]
        tsum = tstats if tsum is None else [a + b for a, b in
                                            zip(tsum, tstats)]
    want = jmetric.finalize(jsum)
    got = tmetric.finalize(tsum)
    assert got == pytest.approx(want, rel=METRIC_RTOL)
    if name == "auc":
        assert 0.5 < got <= 1.0  # predictions that carry the labels


def test_every_reference_metric_name_resolves():
    from analytics_zoo_tpu.pipeline.api.keras import metrics as jm

    assert sorted(tm._METRICS) == sorted(jm._METRICS)
    for name in jm._METRICS:
        assert tm.get_metric(name).name == jm.get_metric(name).name
    with pytest.raises(ValueError, match="unknown metric"):
        tm.get_metric("no_such_metric")


def test_evaluate_auc_mae_mse_matches_the_reference():
    """A binary classifier (Dense(1, sigmoid)) on the reference's weights:
    ``evaluate`` with the loss and ``["auc", "mae", "mse"]``, 40 records
    at batch 16 (a padded tail batch in both packages)."""
    import jax

    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jk
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.convert import params_from_jax
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    def build(keras, layers):
        m = keras.Sequential()
        m.add(layers.Dense(8, activation="relu", input_shape=(6,)))
        m.add(layers.Dense(1, activation="sigmoid"))
        m.compile(optimizer="sgd", loss="binary_crossentropy",
                  metrics=["auc", "mae", "mse"])
        return m

    jax_init(seed=4)
    jnet = build(jk, jl)
    jnet.build_params()
    init_zoo_context(seed=4, device="cpu")
    tnet = build(tk, tl)
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    gen = np.random.default_rng(5)
    x = gen.normal(size=(40, 6)).astype(np.float32)
    y = (x[:, :1] + 0.5 * gen.normal(size=(40, 1)) > 0).astype(np.float32)
    want = jnet.evaluate(x, y, batch_size=16)
    got = tnet.evaluate(x, y, batch_size=16)
    assert sorted(got) == sorted(want) == ["auc", "loss", "mae", "mse"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
