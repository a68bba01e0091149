"""The port's text, recommendation, anomaly-detection and seq2seq models
and its ``ZooModel``/``Ranker`` against the JAX package's.

Each model is built in both packages with the same arguments; the port
takes the reference's initial weights (and state: a frozen embedding's
table) through ``params_from_jax``.  Tolerances, relative to the
reference's largest magnitude:

- forward (the served probabilities): 1e-5, the recurrent models 2e-5
  (the port hoists the input products out of the time loop);
- one Adam step through ``fit`` (batch 8: the JAX package's CPU mesh has 8
  devices): the logged loss within 1e-5, every parameter within 1e-4 of
  the reference's after the step (Adam's first step moves each leaf by
  about ``lr`` times the sign of its gradient, so a leaf whose gradient is
  at rounding level may move either way: those leaves are left out, as
  the BERT twin leaves out the key bias); the TextClassifier's hard-coded
  ``Dropout(0.2)`` is set to 0 in both packages for the step (their masks
  come from different generators);
- ``to_wide_deep_features``, ``unroll``, ``detect_anomalies``, ``Seq2seq.
  infer`` and the ``Ranker`` metrics: equal.  (The reference's ``infer``
  with a ``stop_sign`` that a row holds raises: it writes into the
  read-only array ``np.asarray`` gives it; the port's fill is held against
  the same fill of the reference's tokens.)
"""

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu_torch.convert import params_from_jax

SEED = 5
FWD_TOL, RNN_TOL, STEP_TOL = 1e-5, 2e-5, 1e-4


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


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair(name, *args, infos=None, **kwargs):
    """(JAX model, port model) of zoo class ``name``, the port holding the
    reference's initial parameters and state; ``infos`` is each package's
    ``ColumnFeatureInfo`` (the fourth argument) for WideAndDeep."""
    import analytics_zoo_tpu.models as J
    import analytics_zoo_tpu_torch.models as T

    if infos is None:
        jm, tm = (getattr(J, name)(*args, **kwargs),
                  getattr(T, name)(*args, **kwargs))
    else:
        jm = getattr(J, name)(*args[:2], infos[0], *args[3:], **kwargs)
        tm = getattr(T, name)(*args[:2], infos[1], *args[3:], **kwargs)
    jm.model.build_params()
    tm.model.build_params()
    tm.model.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.model.params), device="cpu"))
    tm.model.state = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.model.state), device="cpu")
    return jm, tm


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _one_step_matches(jm, tm, x, y, loss="sparse_categorical_crossentropy",
                      tmp_path=None, lr=1e-3):
    """One Adam step of both from the same weights on one batch of 8: the
    logged losses and the parameters after it."""
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    before = {k: np.asarray(v) for k, v in _leaves(jm.model.params).items()}
    jm.compile(optimizer=JAdam(lr), loss=loss)
    tm.compile(optimizer=Adam(lr), loss=loss)
    jm.set_tensorboard(str(tmp_path), "zoo")
    jm.fit(x, y, batch_size=8, nb_epoch=1)
    tm.fit(x, y, batch_size=8, nb_epoch=1)
    (jloss,) = [v for _, v, _ in
                jm.model._estimator._writers[0].read_scalar("Loss")]
    ((_, tloss),) = tm.model._estimator.loss_log
    assert tloss == pytest.approx(jloss, rel=1e-5)
    got = _leaves(tm.model.params)
    for path, want in _leaves(jm.model.params).items():
        want = np.asarray(want)
        moved = np.abs(want - before[path]) > 0.5 * lr
        a = got[path].detach().numpy()
        assert np.abs(a - want)[moved].max(initial=0.0) <= \
            STEP_TOL * max(np.abs(want).max(), 1e-30), path


def _forward_matches(jm, tm, x, tol):
    want = np.asarray(jm.predict(x, batch_size=8))
    got = tm.predict(x, batch_size=8)
    assert _err(got, want) <= tol
    return got


# ---------------------------------------------------------------------------
# TextClassifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_matches_jax(encoder, tmp_path):
    """Each encoder (sequence 12, token width 8, encoder width 8, vocab
    30, 3 classes): the served probabilities, then one Adam step."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 30, size=(8, 12)).astype(np.int32)
    y = rng.integers(0, 3, size=(8,)).astype(np.int32)
    jm, tm = _pair("TextClassifier", 3, 8, sequence_length=12,
                   encoder=encoder, encoder_output_dim=8, vocab_size=30)
    assert [type(l).__name__ for l in tm.model.layers] == \
        [type(l).__name__ for l in jm.model.layers]
    _forward_matches(jm, tm, x, FWD_TOL if encoder == "cnn" else RNN_TOL)
    for m in (jm, tm):
        (drop,) = [l for l in m.model.layers
                   if type(l).__name__ == "Dropout"]
        drop.p = 0.0
    _one_step_matches(jm, tm, x, y, tmp_path=tmp_path)


def test_text_classifier_with_a_frozen_table():
    """``embedding_weights`` with ``train_embed=False``: no embedding
    parameter, the table in the model's state, the same probabilities."""
    table = np.random.default_rng(2).normal(size=(30, 8)) \
        .astype(np.float32)
    jm, tm = _pair("TextClassifier", 3, 8, sequence_length=12,
                   encoder="gru", encoder_output_dim=8, vocab_size=30,
                   embedding_weights=table, train_embed=False)
    assert "embedding" not in tm.model.params
    np.testing.assert_array_equal(
        tm.model.state["embedding"]["embeddings"].numpy(), table)
    x = np.random.default_rng(3).integers(0, 30, (8, 12)).astype(np.int32)
    _forward_matches(jm, tm, x, RNN_TOL)


# ---------------------------------------------------------------------------
# Recommenders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("include_mf", [True, False])
def test_neural_cf_matches_jax(include_mf, tmp_path):
    """NeuralCF on 0-d id records (``Input(shape=())``): the probabilities,
    ``recommend_for_user``/``recommend_for_item`` giving the same ranking,
    and one Adam step."""
    rng = np.random.default_rng(4)
    users = rng.integers(0, 30, size=(8,))
    items = rng.integers(0, 40, size=(8,))
    y = rng.integers(0, 2, size=(8,)).astype(np.int32)
    jm, tm = _pair("NeuralCF", 30, 40, class_num=2, user_embed=6,
                   item_embed=5, hidden_layers=(12, 6),
                   include_mf=include_mf, mf_embed=4)
    _forward_matches(jm, tm, [users, items], FWD_TOL)
    want = jm.recommend_for_user(3, np.arange(40), max_items=10)
    got = tm.recommend_for_user(3, np.arange(40), max_items=10)
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-5)
    assert [u for u, _ in tm.recommend_for_item(7, np.arange(30))] == \
        [u for u, _ in jm.recommend_for_item(7, np.arange(30))]
    _one_step_matches(jm, tm, [users, items], y, tmp_path=tmp_path)


def _wide_deep_info():
    import analytics_zoo_tpu.models as J
    import analytics_zoo_tpu_torch.models as T

    kw = dict(wide_base_cols=["gender", "age_bucket"],
              wide_base_dims=[2, 5], wide_cross_cols=["gender_age"],
              wide_cross_dims=[10], indicator_cols=["genre"],
              indicator_dims=[4], embed_cols=["user", "item"],
              embed_in_dims=[20, 30], embed_out_dims=[4, 3],
              continuous_cols=["age", "score"])
    return J.ColumnFeatureInfo(**kw), T.ColumnFeatureInfo(**kw)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return {"gender": rng.integers(0, 2, n),
            "age_bucket": rng.integers(0, 5, n),
            "gender_age": rng.integers(0, 17, n),
            "genre": rng.integers(0, 4, n),
            "user": rng.integers(0, 21, n), "item": rng.integers(0, 31, n),
            "age": rng.normal(size=n).astype(np.float32),
            "score": rng.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_wide_and_deep_matches_jax(model_type, tmp_path):
    """Each ``model_type``: ``to_wide_deep_features`` gives equal arrays,
    the probabilities agree, and one Adam step."""
    import analytics_zoo_tpu.models as J
    import analytics_zoo_tpu_torch.models as T

    jinfo, tinfo = _wide_deep_info()
    rows = _rows(8, 5)
    jfeat = J.to_wide_deep_features(rows, jinfo)
    tfeat = T.to_wide_deep_features(rows, tinfo)
    assert len(tfeat) == len(jfeat) == 4
    for a, b in zip(tfeat, jfeat):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jm, tm = _pair("WideAndDeep", model_type, 2, None, (8, 4),
                   infos=(jinfo, tinfo))
    n_in = {"wide": 1, "deep": 3, "wide_n_deep": 4}[model_type]
    feats = tfeat[:1] if model_type == "wide" else \
        tfeat[1:] if model_type == "deep" else tfeat
    assert len(feats) == n_in
    got = _forward_matches(jm, tm, feats, FWD_TOL)
    np.testing.assert_allclose(tm.predict_user_item_pair(feats), got[:, -1])
    y = np.random.default_rng(6).integers(0, 2, 8).astype(np.int32)
    _one_step_matches(jm, tm, feats, y, tmp_path=tmp_path)
    with pytest.raises(NotImplementedError, match="feature rows"):
        tm.recommend_for_user(1, [1, 2])


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_matches_jax(history):
    """Two GRUs (the first returning sequences) over the embedded session,
    with and without the history arm; ``recommend_for_session`` gives the
    same items."""
    rng = np.random.default_rng(7)
    sess = rng.integers(1, 15, size=(8, 4)).astype(np.int32)
    hist = rng.integers(1, 15, size=(8, 6)).astype(np.int32)
    jm, tm = _pair("SessionRecommender", 14, item_embed=6,
                   rnn_hidden_layers=(8, 5), session_length=4,
                   include_history=history, mlp_hidden_layers=(7,),
                   history_length=6)
    x = [sess, hist] if history else sess
    _forward_matches(jm, tm, x, RNN_TOL)
    got = tm.recommend_for_session(x, max_items=3)
    want = jm.recommend_for_session(x, max_items=3)
    assert [[i for i, _ in r] for r in got] == \
        [[i for i, _ in r] for r in want]


# ---------------------------------------------------------------------------
# AnomalyDetector, Seq2seq, Ranker, ZooModel
# ---------------------------------------------------------------------------

def test_anomaly_detector_matches_jax(tmp_path):
    """``unroll`` and ``detect_anomalies`` equal; the stacked LSTMs'
    predictions within 2e-5; one Adam step on the mean squared error."""
    import analytics_zoo_tpu.models as J
    import analytics_zoo_tpu_torch.models as T

    series = np.sin(np.arange(40, dtype=np.float32) / 3.0)
    series[30] = 4.0
    jx, jy = J.AnomalyDetector.unroll(series, 6)
    tx, ty = T.AnomalyDetector.unroll(series, 6)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    two = np.stack([series, series ** 2], axis=1)
    for a, b in zip(T.AnomalyDetector.unroll(two, 5),
                    J.AnomalyDetector.unroll(two, 5)):
        np.testing.assert_array_equal(a, b)
    jm, tm = _pair("AnomalyDetector", feature_shape=(6, 1),
                   hidden_layers=(5, 4), dropouts=(0.0, 0.0))
    x = tx[:8]
    got = _forward_matches(jm, tm, x, RNN_TOL)
    assert T.AnomalyDetector.detect_anomalies(ty[:8], got, 3) == \
        J.AnomalyDetector.detect_anomalies(ty[:8], got, 3)
    _one_step_matches(jm, tm, x, ty[:8], loss="mse", tmp_path=tmp_path)


@pytest.mark.parametrize("bridge", ["pass", "dense"])
def test_seq2seq_matches_jax(bridge):
    """Teacher-forced probabilities within 2e-5 (two stacked LSTMs, sigmoid
    gates), and greedy ``infer`` giving the same tokens, the stop sign
    filled after a row's first."""
    from analytics_zoo_tpu.models import Seq2seq as J
    from analytics_zoo_tpu_torch.models import Seq2seq as T

    jl, tl = (S(vocab_size=12, embed_dim=6, hidden_sizes=(8, 7),
                bridge=bridge) for S in (J, T))
    params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0)))
    tparams = tl.init_params(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, tparams,
                               is_leaf=torch.is_tensor)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            params))
    tp = params_from_jax(params, device="cpu")
    rng = np.random.default_rng(8)
    enc = rng.integers(2, 12, size=(4, 5)).astype(np.int32)
    dec = rng.integers(2, 12, size=(4, 6)).astype(np.int32)
    want = np.asarray(jax.jit(jl.call)(params, [enc, dec]))
    got = tl.call(tp, [torch.from_numpy(enc), torch.from_numpy(dec)])
    assert _err(got.numpy(), want) <= RNN_TOL
    toks = np.asarray(jl.infer(params, enc, start_sign=1, max_len=7))
    np.testing.assert_array_equal(
        tl.infer(tp, enc, start_sign=1, max_len=7), toks)
    # the reference fills after the stop sign in place on the read-only
    # array jnp gives it, and so raises wherever a row holds one: the fill
    # is held against the same fill of its tokens
    stop = int(toks[0, 2])
    filled = toks.copy()
    for row in filled:
        hits = np.where(row == stop)[0]
        if len(hits):
            row[hits[0] + 1:] = stop
    np.testing.assert_array_equal(
        tl.infer(tp, enc, start_sign=1, max_len=7, stop_sign=stop), filled)
    with pytest.raises(ValueError, match="read-only"):
        jl.infer(params, enc, start_sign=1, max_len=7, stop_sign=stop)


def test_ranker_metrics_match_jax():
    """NDCG@k, recall in the top k and MAP over ragged groups, with ties,
    graded relevance and a group with nothing relevant: equal."""
    from analytics_zoo_tpu.models import Ranker as J
    from analytics_zoo_tpu_torch.models import Ranker as T

    rng = np.random.default_rng(9)
    rel = [rng.integers(0, 3, n) for n in (5, 8, 3, 6)] + [np.zeros(4)]
    score = [rng.normal(size=len(r)).round(1) for r in rel]
    for k in (1, 3, 10):
        assert T.ndcg(rel, score, k) == J.ndcg(rel, score, k)
        assert T.recall_top_k(rel, score, k) == J.recall_top_k(rel, score, k)
    for th in (0.0, 1.0):
        assert T.mean_average_precision(rel, score, th) == \
            J.mean_average_precision(rel, score, th)
    assert T.ndcg([[1, 0]], [[2.0, 1.0]], k=2) == 1.0
    assert T.ndcg([], []) == 0.0


def test_save_and_load_model_round_trip(tmp_path):
    """``save_model``/``load_model`` restore the subclass, its
    configuration and its weights (the same predictions); a meta file
    naming a class that is not one of the port's zoo models is refused."""
    import pickle

    from analytics_zoo_tpu_torch.models import (
        ColumnFeatureInfo,
        NeuralCF,
        ZooModel,
    )

    m = NeuralCF(10, 12, user_embed=4, item_embed=4, hidden_layers=(6,),
                 mf_embed=3)
    x = [np.arange(8) % 10, np.arange(8) % 12]
    want = m.predict(x, batch_size=8)
    path = str(tmp_path / "ncf.model")
    m.save_model(path)
    back = ZooModel.load_model(path)
    assert type(back) is NeuralCF and back.hidden_layers == (6,)
    np.testing.assert_array_equal(back.predict(x, batch_size=8), want)
    assert [i for i, _ in back.recommend_for_user(2, np.arange(12))] == \
        [i for i, _ in m.recommend_for_user(2, np.arange(12))]
    # a class of the port that is not a zoo model passes the unpickler's
    # allow-list, and load_model refuses it; a builtin the list refuses
    for cls, err in ((ColumnFeatureInfo, ValueError),
                     (dict, pickle.UnpicklingError)):
        with open(path + ".zoo_meta", "wb") as f:
            pickle.dump({"cls": cls, "cfg": {}}, f)
        with pytest.raises(err):
            ZooModel.load_model(path)
