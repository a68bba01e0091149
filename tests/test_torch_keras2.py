"""The port's Keras-2 layer API against the JAX package's (the twins of
``tests/test_keras2.py``).

Each of the 20 adapter classes is built in both packages with the same
Keras-2 arguments; its parameter tree (names, shapes, dtypes) equals the
reference's, the port takes the reference's initial weights through
``params_from_jax``, and the outputs on the same seeded input agree within
1e-5 of the reference's largest magnitude (the convolutions sum in other
orders).  The functional merges ``maximum``/``minimum``/``average`` serve
the same values; the two refusals (channels-first, a non-zero bias
initializer) raise the reference's ``ValueError``; a Keras-2 ``Sequential``
takes one Adam step as the reference's does (loss within 1e-5 relative,
parameters within 1e-4 of each leaf's largest; batch 8: the JAX package's
CPU mesh has 8 devices) and trains on its own to the reference's accuracy
bar.
"""

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu_torch.convert import params_from_jax

TOL = 1e-5

# (class, args, kwargs, batch-less input shape; a list for the merges)
CASES = [
    ("Dense", (3,), dict(activation="relu", kernel_initializer="he_normal"),
     (6,)),
    ("Dense", (4,), dict(use_bias=False), (6,)),
    ("Activation", ("tanh",), {}, (6,)),
    ("Dropout", (0.3,), {}, (6,)),
    ("Flatten", (), dict(data_format="channels_last"), (3, 4, 2)),
    ("Conv1D", (4, 3), dict(strides=2, padding="same", activation="relu"),
     (10, 5)),
    ("Conv2D", (4, 3), dict(strides=(2, 2), padding="same",
                            use_bias=False), (8, 8, 3)),
    ("Conv2D", (2, (3, 2)), dict(padding="valid"), (7, 6, 3)),
    ("Cropping1D", ((1, 2),), {}, (10, 5)),
    ("LocallyConnected1D", (3, 3), dict(strides=2), (9, 4)),
    ("MaxPooling1D", (), dict(pool_size=2, strides=2), (10, 5)),
    ("AveragePooling1D", (), dict(pool_size=5, strides=5), (10, 5)),
    ("GlobalAveragePooling1D", (), {}, (10, 5)),
    ("GlobalAveragePooling2D", (), dict(data_format="channels_last"),
     (4, 5, 3)),
    ("GlobalAveragePooling3D", (), {}, (3, 4, 5, 2)),
    ("GlobalMaxPooling1D", (), {}, (10, 5)),
    ("GlobalMaxPooling2D", (), {}, (4, 5, 3)),
    ("GlobalMaxPooling3D", (), {}, (3, 4, 5, 2)),
    ("Softmax", (), {}, (7,)),
    ("Maximum", (), {}, [(4, 3), (4, 3)]),
    ("Minimum", (), {}, [(4, 3), (4, 3)]),
    ("Average", (), {}, [(4, 3), (4, 3), (4, 3)]),
]


@pytest.fixture(autouse=True)
def _contexts():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init

    saved = (jax_engine._CONTEXT, torch_engine._CONTEXT,
             torch.get_num_threads())
    torch.set_num_threads(1)
    jax_init(seed=0)
    torch_init(seed=0, device="cpu")
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved[:2]
    torch.set_num_threads(saved[2])


def _layers():
    from analytics_zoo_tpu.pipeline.api.keras2 import layers as J
    from analytics_zoo_tpu_torch.pipeline.api.keras2 import layers as T

    return J, T


def _shapes(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(np.shape(a)), str(np.asarray(a).dtype)), tree)


@pytest.mark.parametrize("name, args, kwargs, shape", CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_keras2_layer_matches_jax(name, args, kwargs, shape):
    J, T = _layers()
    jl, tl = getattr(J, name)(*args, **kwargs), getattr(T, name)(*args,
                                                                 **kwargs)
    jl.ensure_built(shape)
    tl.ensure_built(shape)
    jp = jax.tree_util.tree_map(np.asarray,
                                jl.init_params(jax.random.PRNGKey(0)))
    mine = jax.tree_util.tree_map(
        lambda t: t.numpy(), tl.init_params(torch.Generator().manual_seed(0)))
    assert _shapes(mine) == _shapes(jp)
    rng = np.random.default_rng(1)
    shapes = shape if isinstance(shape, list) else [shape]
    xs = [rng.normal(size=(3,) + s).astype(np.float32) for s in shapes]
    x = xs if isinstance(shape, list) else xs[0]
    want, _ = jl.apply(jp, x)
    got, _ = tl.apply(params_from_jax(jp, device="cpu"),
                      [torch.from_numpy(a) for a in xs]
                      if isinstance(shape, list) else torch.from_numpy(x))
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL * max(
        np.abs(want).max(), 1e-30)
    assert tl.compute_output_shape(
        [(None,) + s for s in shapes] if isinstance(shape, list)
        else (None,) + shape) == jl.compute_output_shape(
        [(None,) + s for s in shapes] if isinstance(shape, list)
        else (None,) + shape)


def test_argument_translation_matches_jax():
    """The Keras-2 names land on the Keras-1 attributes as in the
    reference: ``rate`` → ``p``, ``units`` → ``output_dim``,
    ``filters``/``strides``/``padding`` → ``nb_filter``/``subsample``/
    ``border_mode``, ``pool_size``/``strides`` → the pool length and
    stride."""
    J, T = _layers()
    for name, args, kwargs, attrs in [
            ("Dropout", (0.3,), {}, ("p",)),
            ("Dense", (5,), dict(use_bias=False), ("output_dim", "bias")),
            ("Conv2D", (4, 3), dict(strides=(2, 2), padding="same"),
             ("nb_filter", "subsample", "border_mode", "bias")),
            ("Conv1D", (4, 3), dict(strides=2),
             ("nb_filter", "border_mode")),
            ("MaxPooling1D", (), dict(pool_size=3, strides=1),
             ("pool_size", "strides", "border_mode")),
    ]:
        jl, tl = getattr(J, name)(*args, **kwargs), getattr(T, name)(
            *args, **kwargs)
        for a in attrs:
            assert getattr(tl, a) == getattr(jl, a), (name, a)


def test_functional_merges_match_jax():
    """``maximum``, ``minimum`` and ``average`` over two inputs in a Keras-2
    ``Model``: the values of ``np.maximum``/``np.minimum``/the mean, as the
    reference serves them."""
    from analytics_zoo_tpu.pipeline.api.keras.engine import Input as JInput
    from analytics_zoo_tpu.pipeline.api.keras2 import Model as JModel
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
    from analytics_zoo_tpu_torch.pipeline.api.keras2 import Model

    J, T = _layers()
    rng = np.random.default_rng(2)
    xa = rng.normal(size=(8, 4)).astype(np.float32)
    xb = rng.normal(size=(8, 4)).astype(np.float32)
    for fn, want in (("maximum", np.maximum(xa, xb)),
                     ("minimum", np.minimum(xa, xb)),
                     ("average", (xa + xb) / 2)):
        outs = []
        for L, In, M in ((J, JInput, JModel), (T, Input, Model)):
            a, b = In(shape=(4,)), In(shape=(4,))
            m = M([a, b], getattr(L, fn)([a, b]))
            outs.append(np.asarray(m.predict([xa, xb], batch_size=8)))
        np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)
        np.testing.assert_allclose(outs[1], want, atol=1e-6)


def test_refusals_raise_the_references_value_error():
    J, T = _layers()
    for L in (J, T):
        with pytest.raises(ValueError, match="channels-last"):
            L.Conv2D(4, 3, data_format="channels_first")
        with pytest.raises(ValueError, match="channels-last"):
            L.GlobalMaxPooling2D(data_format="channels_first")
        with pytest.raises(ValueError, match="zero bias"):
            L.Conv2D(4, 3, bias_initializer="ones")
        with pytest.raises(ValueError, match="zero bias"):
            L.Dense(4, bias_initializer="glorot_uniform")
        # use_bias=False makes any initializer acceptable; zero spellings
        L.Dense(4, use_bias=False, bias_initializer="ones")
        L.Dense(4, bias_initializer="Zeros")

        class Zeros:
            pass

        L.Dense(4, bias_initializer=Zeros())


def _sequential(pkg):
    if pkg == "jax":
        from analytics_zoo_tpu.pipeline.api.keras2 import Sequential
    else:
        from analytics_zoo_tpu_torch.pipeline.api.keras2 import Sequential
    L = _layers()[0 if pkg == "jax" else 1]
    m = Sequential()
    m.add(L.Dense(16, activation="relu", input_shape=(8,)))
    m.add(L.Dropout(0.0))
    m.add(L.Dense(2))
    m.add(L.Softmax())
    return m


def test_keras2_sequential_step_matches_jax(tmp_path):
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    y = (x.sum(-1) > 0).astype(np.int32)
    jm, tm = _sequential("jax"), _sequential("torch")
    jm.build_params()
    tm.build_params()
    tm.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), device="cpu"))
    before = jax.tree_util.tree_map(np.asarray, jm.params)
    loss = "sparse_categorical_crossentropy"
    jm.compile(optimizer=JAdam(1e-3), loss=loss)
    tm.compile(optimizer=Adam(1e-3), loss=loss)
    jm.set_tensorboard(str(tmp_path), "zoo")
    jm.fit(x, y, batch_size=8, nb_epoch=1)
    tm.fit(x, y, batch_size=8, nb_epoch=1)
    (jloss,) = {v for _, v, _ in jm._estimator._writers[0].read_scalar(
        "Loss")}
    ((_, tloss),) = tm._estimator.loss_log
    assert tloss == pytest.approx(jloss, rel=1e-5)
    for layer, leaves in jm.params.items():
        for key, want in leaves.items():
            want = np.asarray(want)
            moved = np.abs(want - before[layer][key]) > 0.5e-3
            got = tm.params[layer][key].numpy()
            assert np.abs(got - want)[moved].max(initial=0.0) <= \
                1e-4 * np.abs(want).max(), (layer, key)


def test_keras2_sequential_trains():
    """The port's twin of ``test_keras2_sequential_trains``: accuracy
    above 0.8 after 60 epochs."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x.sum(-1) > 0).astype(np.int64)
    m = _sequential("torch")
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    m.fit(x, y, batch_size=32, nb_epoch=60)
    res = m.evaluate(x, y, batch_size=32)
    assert res["accuracy"] > 0.8, res
