"""The port's training slice against the JAX package's: ``compile`` →
``fit`` → ``evaluate`` of a small BERT classifier.

The same BERT (2 blocks, hidden 128, 2 heads of d = 64, sequence 256) with
a Dense(2) logits head is built in both packages; the port takes the
reference's weights through ``params_from_jax``.  Both train 3 steps with
``Adam`` and ``sparse_categorical_crossentropy_from_logits``, hidden and
attention dropout 0, on the same numpy data.  Sequence 256 routes attention
to flash in both: the reference's Pallas kernels in interpret mode
(``ZOO_FLASH_INTERPRET=1``), the port's plain flash forward and backward on
the CPU.  Tolerances, all f32:

- batches: bit for bit (both shuffle with the same numpy permutation);
- step-1 gradients: within 1e-4 of each leaf's largest value;
- per-step losses and ``evaluate``'s loss: 1e-5 relative (measured ~1e-6);
- parameters after 3 steps: 1e-3 relative L2 per leaf (the updates differ
  by ~1e-5 where optax and the fused Adam round 1 - b2 differently), but
  for the key biases, whose gradient is rounding noise (see below).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common.utils import tree_leaves
from analytics_zoo_tpu_torch.convert import opt_state_from_jax, params_from_jax

VOCAB, HIDDEN, BLOCKS, HEADS, INTER, SEQ = 100, 128, 2, 2, 256, 256
# the JAX package's batch must divide its 8-device CPU mesh
N, BATCH, SEED = 24, 8, 3
LR = 1e-3


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _paths(tree, prefix=()):
    """Leaf paths in JAX's order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (i,))]
    return [prefix]


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32)
    types = rng.integers(0, 2, (n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    lengths = rng.integers(SEQ // 4, SEQ + 1, n)
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.float32)
    return [ids, types, pos, mask], rng.integers(0, 2, n).astype(np.int32)


def _build(keras, layers):
    ins = [keras.Input((SEQ,)) for _ in range(4)]
    _, pooled = layers.BERT(
        vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS, n_head=HEADS,
        seq_len=SEQ, intermediate_size=INTER, hidden_p_drop=0.0,
        attn_p_drop=0.0)(ins)
    return keras.Model(ins, layers.Dense(2)(pooled))


@pytest.fixture(autouse=True)
def _restore_contexts():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine

    saved = jax_engine._CONTEXT, torch_engine._CONTEXT
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved


def _pair(jk, jl, tk, tl):
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init

    jax_init(seed=SEED)
    torch_init(seed=SEED, device="cpu")
    jnet, tnet = _build(jk, jl), _build(tk, tl)
    jnet.build_params()
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    return jnet, tnet


def test_fit_and_evaluate_match_jax(monkeypatch, tmp_path):
    from analytics_zoo_tpu.pipeline.api import keras as jk
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu.pipeline.api.keras.objectives import (
        get_loss as jget_loss,
    )
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    jnet, tnet = _pair(jk, jl, tk, tl)
    loss = "sparse_categorical_crossentropy_from_logits"
    jnet.compile(optimizer=JAdam(LR), loss=loss, metrics=["accuracy"])
    jnet.set_tensorboard(str(tmp_path), "bert")
    tnet.compile(optimizer=Adam(LR), loss=loss, metrics=["accuracy"])
    x, y = _data(N, 1)

    # step 1's gradients, from the same weights and the first batch
    first = next(FeatureSet.of(x, y).batches(BATCH, seed=SEED, epoch=1))
    jloss_fn = jget_loss(loss)

    def jloss(p):
        preds, _ = jnet.forward(p, [jnp.asarray(a) for a in first["x"]],
                                state=jnet.state, training=True,
                                rng=jax.random.PRNGKey(0))
        return jloss_fn.mean(jnp.asarray(first["y"]), preds)

    jval, jgrads = jax.value_and_grad(jloss)(jnet.params)
    est = tnet._make_estimator()
    tval, tgrads, _ = est.loss_and_grads(
        tnet.params, tnet.state, _to_device(first, "cpu"),
        step_generator(SEED, 0, "cpu"))
    assert float(tval) == pytest.approx(float(jval), rel=1e-5)
    for a, b in zip(_leaves(tgrads), _leaves(jgrads)):
        b = np.asarray(b)
        assert np.abs(_np(a) - b).max() <= 1e-4 * np.abs(b).max()

    jnet.fit(x, y, batch_size=BATCH, nb_epoch=1)
    tnet.fit(x, y, batch_size=BATCH, nb_epoch=1)
    jlosses = dict((s, v) for s, v, _ in
                   jnet._estimator._writers[0].read_scalar("Loss"))
    tlosses = dict(tnet._estimator.loss_log)
    assert sorted(tlosses) == sorted(jlosses) == [1, 2, 3]
    for s in jlosses:
        assert tlosses[s] == pytest.approx(jlosses[s], rel=1e-5)
    assert tnet._estimator.history[-1]["loss"] == pytest.approx(
        jnet._estimator.history[-1]["loss"], rel=1e-5)
    for path, a, b in zip(_paths(jnet.params), _leaves(tnet.params),
                          _leaves(jnet.params)):
        a, b = _np(a), np.asarray(b)
        if path[-1] == "qkv_bias":
            # The key bias adds the same q.b to every score of a row, which
            # the softmax cancels: its gradient is 0 up to rounding noise,
            # Adam turns noise into steps of ~lr of either sign, and the
            # two packages' noise differs.  Both stay within 3 steps of lr;
            # the query and value biases are compared as usual.
            keys = slice(HIDDEN, 2 * HIDDEN)
            assert np.abs(a[keys]).max() <= 3 * LR * 1.01
            assert np.abs(b[keys]).max() <= 3 * LR * 1.01
            a, b = np.delete(a, np.s_[keys]), np.delete(b, np.s_[keys])
        assert _rel(a, b) <= 1e-3, path

    got = tnet.evaluate(x, y, batch_size=BATCH)
    want = jnet.evaluate(x, y, batch_size=BATCH)
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["accuracy"] == want["accuracy"]

    # the reference's optimizer state carries over
    state = opt_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jnet._estimator._opt_state), device="cpu")
    own = tnet._estimator._opt_state
    assert int(state.count) == int(own.count) == 3
    for a, b in zip(_leaves(own.mu) + _leaves(own.nu),
                    _leaves(state.mu) + _leaves(state.nu)):
        assert _rel(_np(a), _np(b)) <= 1e-3


def test_batch_order_matches_jax():
    """FeatureSet batches: the same arrays in the same order, bit for bit,
    shuffled or not, padded or not, through a per-record transform."""
    from analytics_zoo_tpu.feature.common import FnPreprocessing as JFn
    from analytics_zoo_tpu.feature.dataset import FeatureSet as JFS
    from analytics_zoo_tpu_torch.feature.common import FnPreprocessing
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet

    x, y = _data(11, 2)
    w = np.random.default_rng(3).random(11).astype(np.float32)
    tfs, jfs = FeatureSet.of(x, y, w), JFS.of(x, y, w)
    assert tfs.num_samples == jfs.num_samples == 11
    kwargs = [dict(shuffle=True, seed=SEED, epoch=e) for e in (1, 2)] + [
        dict(shuffle=False, drop_last=False, pad_to_batch=4),
        dict(shuffle=True, seed=9, epoch=1, drop_last=False)]
    for kw in kwargs:
        got = list(tfs.batches(3, **kw))
        want = list(jfs.batches(3, **kw))
        assert len(got) == len(want) > 0
        for g, wb in zip(got, want):
            assert sorted(g) == sorted(wb)
            for k in g:
                for a, b in zip(g[k] if isinstance(g[k], list) else [g[k]],
                                wb[k] if isinstance(wb[k], list)
                                else [wb[k]]):
                    np.testing.assert_array_equal(a, b)
    tt = FeatureSet.of(x[3], y).transform(FnPreprocessing(lambda r: r * 2))
    jt = JFS.of(x[3], y).transform(JFn(lambda r: r * 2))
    for g, wb in zip(tt.batches(4, seed=1, epoch=1),
                     jt.batches(4, seed=1, epoch=1)):
        np.testing.assert_array_equal(g["x"], wb["x"])
    assert tt.num_samples == jt.num_samples == 11


@pytest.mark.parametrize("clip", [("l2norm", 0.5), ("const", -0.1, 0.2),
                                  0.3, None])
def test_gradient_clipping_matches_jax(clip):
    from analytics_zoo_tpu.pipeline.estimator.estimator import (
        _clip_grads as jclip,
    )
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _clip_grads,
    )

    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": [rng.normal(size=5).astype(np.float32)]}
    got = _clip_grads({"a": torch.from_numpy(tree["a"]),
                       "b": [torch.from_numpy(tree["b"][0])]}, clip)
    want = jclip(jax.tree_util.tree_map(jnp.asarray, tree), clip)
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_freeze_and_clipping_train_like_jax():
    """A Dense stack with its first layer frozen and the gradient clipped
    by norm: the frozen layer keeps its weights in both packages, and the
    trained one matches."""
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSeq
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    def build(seq, dense):
        m = seq()
        m.add(dense(16, activation="relu", input_shape=(12,)))
        m.add(dense(3))
        return m

    jax_init(seed=5)
    init_zoo_context(seed=5, device="cpu")
    jm, tm = build(JSeq, JDense), build(Sequential, Dense)
    jm.build_params()
    tm.build_params()
    tm.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu"))
    frozen = {k: v.clone() for k, v in tm.params["dense_0"].items()}
    rng = np.random.default_rng(6)
    x = rng.normal(size=(16, 12)).astype(np.float32)
    y = rng.integers(0, 3, 16).astype(np.int32)
    for m in (jm, tm):
        m.compile(optimizer="adam",
                  loss="sparse_categorical_crossentropy_from_logits")
        m.freeze("dense_0")
        m.set_gradient_clipping_by_l2_norm(0.1)
        m.fit(x, y, batch_size=8, nb_epoch=2)
    assert tm.frozen_layers == jm.frozen_layers == ["dense_0"]
    for k, v in frozen.items():
        assert torch.equal(tm.params["dense_0"][k], v)
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(_np(tm.params["dense_1"][k]),
                                   np.asarray(jm.params["dense_1"][k]),
                                   rtol=1e-4, atol=1e-6)
        assert not np.allclose(_np(tm.params["dense_1"][k]),
                               np.asarray(jm.params["dense_1"][k]) * 0)
    assert [h["epoch"] for h in tm._estimator.history] == [1, 2]
    tm.unfreeze()
    assert tm.frozen_layers == []


def test_compile_contract(tmp_path):
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import (
        KerasNet,
        Sequential,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
        Adam,
        warmup_linear_decay,
    )

    init_zoo_context(seed=1, device="cpu")
    m = Sequential()
    m.add(Dense(2, input_shape=(3,)))
    x = np.ones((4, 3), np.float32)
    y = np.zeros(4, np.int32)
    with pytest.raises(RuntimeError, match="compile"):
        m.fit(x, y, batch_size=2, nb_epoch=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.compile(optimizer="rmsprop", loss="mse")
    m.compile(optimizer=Adam(1e-2, schedule=warmup_linear_decay(1, 4)),
              loss="sparse_categorical_crossentropy_from_logits",
              metrics=["accuracy"])
    m.fit(x, y, batch_size=2, nb_epoch=1, validation_data=(x, y))
    assert len(m._estimator.loss_log) == 2
    # a compiled model (schedule closures included) saves and loads
    path = os.path.join(tmp_path, "m.model")
    m.save(path)
    loaded = KerasNet.load(path, device="cpu")
    assert torch.equal(loaded.params["dense_0"]["kernel"],
                       m.params["dense_0"]["kernel"])
    assert m._compiled is not None and loaded._compiled is None
    assert sorted(m.evaluate(x, y)) == ["accuracy", "loss"]
    assert all(np.isfinite(v) for _, v in m._estimator.loss_log)
    assert tree_leaves(m.params)[0].device.type == "cpu"
