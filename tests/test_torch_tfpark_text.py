"""The port's tfpark ``KerasModel`` and text taggers against the JAX
package's.

``NER``, ``SequenceTagger`` (with and without the char input) and
``IntentEntity`` are built in both packages with the same arguments at a
few timesteps and narrow widths; the port takes the reference's initial
weights through ``params_from_jax`` (the trees equal: names, shapes,
dtypes).  Tolerances, relative to the reference's largest magnitude:

- forward (each head's probabilities): 2e-5 (the port hoists the LSTM's
  input products out of the time loop); each row sums to 1;
- one Adam step through ``fit`` (batch 8: the JAX package's CPU mesh has
  8 devices) on one label, or on a list of two labels for the two-head
  taggers (``MultiOutputLoss`` sums the heads' losses): the loss within
  1e-5 relative, every parameter within 1e-4 (leaves moved by less than
  half the rate left out, as in the other step twins).  Dropout is set to
  0 in both packages for the step (their masks come from different
  generators);
- ``MultiOutputLoss`` and ``char_word_features`` on their own: 1e-6;
- ``KerasModel``: the wrapped net's predictions 1e-5, and its save/load,
  weights and ``predict_classes`` round trips equal.

The two-head ``evaluate`` sums the heads' per-sample losses as the
reference's does.  Importing tfpark's estimators raises
``NotImplementedError`` naming ROADMAP item 21.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu_torch.convert import params_from_jax

SEED = 17
FWD_TOL, STEP_TOL = 2e-5, 1e-4
SEQ, WLEN, VOCAB, CVOCAB, N = 5, 3, 30, 12, 8


@pytest.fixture(autouse=True)
def _contexts():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init

    saved = (jax_engine._CONTEXT, torch_engine._CONTEXT,
             torch.get_num_threads())
    torch.set_num_threads(1)
    jax_init(seed=SEED)
    torch_init(seed=SEED, device="cpu")
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved[:2]
    torch.set_num_threads(saved[2])


def _data():
    rng = np.random.default_rng(SEED)
    words = rng.integers(1, VOCAB, size=(N, SEQ)).astype(np.int32)
    chars = rng.integers(1, CVOCAB, size=(N, SEQ, WLEN)).astype(np.int32)
    return words, chars, (words % 4).astype(np.int32), \
        (words % 3).astype(np.int32), (words[:, 0] % 3).astype(np.int32)


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _shapes(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(np.shape(a)), str(np.asarray(a).dtype)), tree)


TAGGERS = {
    "NER": dict(num_entities=4, word_vocab_size=VOCAB,
                char_vocab_size=CVOCAB, word_length=WLEN, seq_len=SEQ,
                word_emb_dim=6, char_emb_dim=4, tagger_lstm_dim=5),
    "SequenceTagger": dict(num_pos_labels=3, num_chunk_labels=4,
                           word_vocab_size=VOCAB, seq_len=SEQ,
                           feature_size=6),
    "SequenceTagger_chars": dict(num_pos_labels=3, num_chunk_labels=4,
                                 word_vocab_size=VOCAB,
                                 char_vocab_size=CVOCAB, word_length=WLEN,
                                 seq_len=SEQ, feature_size=6),
    "IntentEntity": dict(num_intents=3, num_entities=4,
                         word_vocab_size=VOCAB, char_vocab_size=CVOCAB,
                         word_length=WLEN, seq_len=SEQ, word_emb_dim=6,
                         char_emb_dim=4, char_lstm_dim=4,
                         tagger_lstm_dim=5),
}


def _tagger_pair(name):
    import analytics_zoo_tpu.tfpark.text.keras as J
    import analytics_zoo_tpu_torch.tfpark.text.keras as T

    cls = name.split("_")[0]
    jm, tm = getattr(J, cls)(**TAGGERS[name]), getattr(T, cls)(
        **TAGGERS[name])
    jm.model.build_params()
    tm.model.build_params()
    assert _shapes(tm.model.get_weights()) == _shapes(jm.model.params)
    tm.model.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.model.params), device="cpu"))
    return jm, tm


def _inputs_and_labels(name):
    words, chars, tags, pos, intents = _data()
    x = {"NER": [words, chars], "SequenceTagger": words,
         "SequenceTagger_chars": [words, chars],
         "IntentEntity": [words, chars]}[name]
    y = {"NER": tags, "SequenceTagger": [pos, tags],
         "SequenceTagger_chars": [pos, tags],
         "IntentEntity": [intents, tags]}[name]
    return x, y


@pytest.mark.parametrize("name", list(TAGGERS))
def test_tagger_forward_matches_jax(name):
    jm, tm = _tagger_pair(name)
    x, _ = _inputs_and_labels(name)
    want = jm.predict(x, batch_size=8)
    got = tm.predict(x, batch_size=8)
    wants = want if isinstance(want, list) else [want]
    gots = got if isinstance(got, list) else [got]
    assert len(gots) == len(wants) == (1 if name == "NER" else 2)
    for g, w in zip(gots, wants):
        assert _err(g, w) <= FWD_TOL
        np.testing.assert_allclose(g.sum(-1), 1.0, atol=1e-5)
    classes = tm.predict_classes(x)
    classes = classes if isinstance(classes, list) else [classes]
    for c, g in zip(classes, gots):
        np.testing.assert_array_equal(c, np.argmax(g, -1))


@pytest.mark.parametrize("name", list(TAGGERS))
def test_tagger_step_matches_jax(name, tmp_path):
    """One Adam step, a list of two labels for the two-head taggers; then
    ``evaluate``'s summed loss."""
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    jm, tm = _tagger_pair(name)
    for m in (jm, tm):
        for layer in m.model.layers:
            if type(layer).__name__ == "Dropout":
                layer.p = 0.0
    x, y = _inputs_and_labels(name)
    lr = 1e-2
    before = jax.tree_util.tree_map(np.asarray, jm.model.params)
    # recompile both with the same optimizer (the taggers compile Adam's
    # default rate in their constructors)
    for m, opt in ((jm, JAdam(lr)), (tm, Adam(lr))):
        m.model.compile(optimizer=opt, loss=m.model._compiled["loss"])
    jm.model.set_tensorboard(str(tmp_path), "zoo")
    jm.fit(x, y, batch_size=8, epochs=1)
    tm.fit(x, y, batch_size=8, epochs=1)
    (jloss,) = {v for _, v, _ in
                jm.model._estimator._writers[0].read_scalar("Loss")}
    ((_, tloss),) = tm.model._estimator.loss_log
    assert tloss == pytest.approx(jloss, rel=1e-5)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k in sorted(tree)
                    for p, v in leaves(tree[k], f"{prefix}/{k}").items()}
        return {prefix: tree}

    got = leaves(tm.model.params)
    for path, want in leaves(jm.model.params).items():
        want = np.asarray(want)
        moved = np.abs(want - leaves(before)[path]) > 0.5 * lr
        assert np.abs(got[path].numpy() - want)[moved].max(initial=0.0) \
            <= STEP_TOL * np.abs(want).max(), path
    want = jm.evaluate(x, y, batch_size=8)
    got = tm.evaluate(x, y, batch_size=8)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def test_multi_output_loss_and_char_features_match_jax():
    from analytics_zoo_tpu.tfpark.text.keras import ner as jner
    from analytics_zoo_tpu.tfpark.text.keras.text_model import (
        MultiOutputLoss as JLoss,
    )
    from analytics_zoo_tpu_torch.tfpark.text.keras import ner as tner
    from analytics_zoo_tpu_torch.tfpark.text.keras.text_model import (
        MultiOutputLoss,
    )

    rng = np.random.default_rng(3)
    p1 = rng.dirichlet(np.ones(3), size=(6, 4)).astype(np.float32)
    p2 = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    y1 = rng.integers(0, 3, (6, 4)).astype(np.int32)
    y2 = rng.integers(0, 5, 6).astype(np.int32)
    names = ["sparse_categorical_crossentropy"] * 2
    want = np.asarray(JLoss(names, weights=[1.0, 0.5])(
        [jnp.asarray(y1), jnp.asarray(y2)], [jnp.asarray(p1),
                                             jnp.asarray(p2)]))
    got = MultiOutputLoss(names, weights=[1.0, 0.5])(
        [torch.from_numpy(y1), torch.from_numpy(y2)],
        [torch.from_numpy(p1), torch.from_numpy(p2)])
    assert got.shape == want.shape == (6,)
    assert _err(got.numpy(), want) <= 1e-6
    # the char features: the mean of each word's char embeddings
    from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
    from analytics_zoo_tpu_torch.pipeline.api.keras import Model

    outs = []
    _, chars, _, _, _ = _data()
    for mod, M in ((jner, JModel), (tner, Model)):
        ins, feats = mod.char_word_features(SEQ, WLEN, CVOCAB, 4)
        net = M(ins, feats)
        net.build_params()
        outs.append(net)
    outs[1].set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, outs[0].params), device="cpu"))
    want = np.asarray(outs[0].predict(chars, batch_size=8))
    got = outs[1].predict(chars, batch_size=8)
    assert got.shape == (N, SEQ, 4)
    assert _err(got, want) <= 1e-6


def _keras_model_pair():
    from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSeq
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
    from analytics_zoo_tpu.tfpark import KerasModel as JKM
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.tfpark import KerasModel

    nets = []
    for S, D in ((JSeq, JDense), (Sequential, Dense)):
        net = S()
        net.add(D(6, activation="relu", input_shape=(4,)))
        net.add(D(3, activation="softmax"))
        net.compile(optimizer="adam",
                    loss="sparse_categorical_crossentropy",
                    metrics=["accuracy"])
        net.build_params()
        nets.append(net)
    nets[1].set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, nets[0].params), device="cpu"))
    return JKM(nets[0]), KerasModel(nets[1])


def test_keras_model_matches_jax(tmp_path):
    jkm, km = _keras_model_pair()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = rng.integers(0, 3, 16).astype(np.int32)
    want = np.asarray(jkm.predict(x, batch_size=8))
    assert _err(km.predict(x, batch_size=8), want) <= 1e-5
    np.testing.assert_array_equal(km.predict_classes(x, batch_size=8),
                                  np.argmax(km.predict(x), -1))
    assert km.evaluate(x, y, batch_size=8)["loss"] == pytest.approx(
        jkm.evaluate(x, y, batch_size=8)["loss"], rel=1e-5)
    km.fit(x, y, batch_size=8, epochs=2)
    assert km.model._estimator.global_step == 4
    path = str(tmp_path / "m.zoo")
    km.save_model(path)
    back = type(km).load_model(path)
    np.testing.assert_array_equal(back.predict(x), km.predict(x))
    wpath = str(tmp_path / "w.npz")
    km.save_weights(wpath)
    other = _keras_model_pair()[1]
    other.load_weights(wpath)
    np.testing.assert_array_equal(other.predict(x), km.predict(x))
    other.set_weights(km.get_weights())
    np.testing.assert_array_equal(other.predict(x), km.predict(x))


def test_text_keras_model_save_and_load(tmp_path):
    from analytics_zoo_tpu_torch.tfpark.text.keras import (
        SequenceTagger,
        TextKerasModel,
    )

    _, tm = _tagger_pair("SequenceTagger")
    x, _ = _inputs_and_labels("SequenceTagger")
    path = str(tmp_path / "tagger.zoo")
    tm.save_model(path)
    back = SequenceTagger.load_model(path)
    assert isinstance(back, TextKerasModel) and type(back) is SequenceTagger
    for a, b in zip(back.predict(x), tm.predict(x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["TFEstimator", "TFEstimatorSpec",
                                  "ZooOptimizer", "sparse_ce",
                                  "GANEstimator"])
def test_tfpark_names_resolve_to_the_port(name):
    import importlib

    tfpark = importlib.import_module("analytics_zoo_tpu_torch.tfpark")
    reference = importlib.import_module("analytics_zoo_tpu.tfpark")
    obj = getattr(tfpark, name)
    assert obj.__module__.startswith("analytics_zoo_tpu_torch.tfpark.")
    assert obj.__name__ == getattr(reference, name).__name__
    assert name in tfpark.__all__
    from analytics_zoo_tpu_torch.tfpark.text import estimator

    assert estimator.BERTSquad.__module__ == \
        "analytics_zoo_tpu_torch.tfpark.text.estimator.bert_squad"
