"""The port's text-matching path against the JAX package's: ``TextSet``,
the relation readers, KNRM with ``rank_hinge`` and the ranking metrics, and
WideAndDeep's id pickers as ``LambdaOp`` nodes.

- ``TextSet``: every pipeline stage gives the reference's tokens, word
  index and arrays (equal); the word index saved by one package loads in
  the other; CSV and parquet relations and texts read alike;
  ``from_relation_pairs``/``from_relation_lists`` give equal arrays.
- KNRM (query 4, document 6 tokens, vocabulary 30, width 8, the default
  21 kernels), the port holding the reference's initial table and score
  weights (``params_from_jax``): the pooled kernel features within 1e-5
  and the scores within 1e-5 of the reference's largest magnitude, on a
  batch in which some documents repeat query tokens and one document is
  its query (so the exact-match kernel, ``exp(-(sim - 1)^2 / 2e-6)``, sees
  cosines of one within rounding); one Adam step on ``rank_hinge``
  through ``fit`` (batch 8: the JAX package's CPU mesh has 8 devices):
  the loss within 1e-5 relative, every parameter within 1e-4 of its
  leaf's largest; ``evaluate_ndcg`` (k = 1 and 3) and ``evaluate_map``
  within 1e-6.
- WideAndDeep: the parameter tree is the one the private ``_Column``
  picker gave (pinned below: names, shapes, order), and the served
  probabilities match the reference's within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu_torch.convert import params_from_jax

SEED = 9
TOL, STEP_TOL = 1e-5, 1e-4
TEXTS = ["The quick brown fox jumps", "the lazy dog sleeps, the end",
         "Quick! A fox-like dog?", "brown dogs and brown foxes", "end"]


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


def _text():
    import analytics_zoo_tpu.feature.text as J
    import analytics_zoo_tpu_torch.feature.text as T

    return J, T


def _same_features(a, b):
    assert len(a.features) == len(b.features)
    for fa, fb in zip(a.features, b.features):
        assert (fa.text, fa.label, fa.uri, fa.tokens) == \
            (fb.text, fb.label, fb.uri, fb.tokens)
        if fb.indices is None:
            assert fa.indices is None
        else:
            assert fa.indices.dtype == fb.indices.dtype
            np.testing.assert_array_equal(fa.indices, fb.indices)


@pytest.mark.parametrize("word2idx, mode", [
    (dict(), "pre"), (dict(remove_topn=1), "post"),
    (dict(max_words_num=4), "pre"),
    (dict(existing_map={"the": 3, "fox": 1, "dog": 2}), "post")])
def test_textset_stages_match_jax(word2idx, mode):
    J, T = _text()
    sets = []
    for M in (J, T):
        ts = M.TextSet.from_texts(TEXTS, labels=[0, 1, 0, 1, 1])
        _same = ts.tokenize().normalize().word2idx(**word2idx)
        assert _same is ts
        ts.shape_sequence(4, mode=mode).generate_sample()
        sets.append(ts)
    _same_features(*sets)
    assert sets[1].get_word_index() == sets[0].get_word_index()
    fj, ft = sets[0].to_feature_set(), sets[1].to_feature_set()
    for a, b in zip(ft.xs + ft.ys, fj.xs + fj.ys):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_word_index_round_trip_between_the_packages(tmp_path):
    J, T = _text()
    for src, dst in ((J, T), (T, J)):
        ts = src.TextSet.from_texts(TEXTS).tokenize().normalize().word2idx()
        path = str(tmp_path / "word_index.txt")
        ts.save_word_index(path)
        back = dst.TextSet.from_texts(["the fox ran"]).tokenize() \
            .normalize()
        back.load_word_index(path)
        back.word2idx()
        wi = ts.get_word_index()
        assert back.get_word_index() == wi
        np.testing.assert_array_equal(back.features[0].indices,
                                      [wi["the"], wi["fox"], 0])
    with pytest.raises(ValueError, match="wordIndex"):
        T.TextSet.from_texts(["abc"]).save_word_index(str(tmp_path / "w"))
    ts = T.TextSet.from_texts(["b a"]).tokenize().normalize()
    ts.set_word_index({"a": 1, "b": 2}).word2idx()
    np.testing.assert_array_equal(ts.features[0].indices, [2, 1])


def test_csv_and_parquet_relations_and_texts_match_jax(tmp_path):
    import pandas as pd

    J, T = _text()
    csv = tmp_path / "rel.csv"
    csv.write_text("id1,id2,label\nq1,d1,1\nq1,d2,0\nq2,d3,1\n")
    pq = str(tmp_path / "rel.parquet")
    pd.DataFrame({"id1": ["q1", "q1", "q2"], "id2": ["d1", "d2", "d3"],
                  "label": [1, 0, 1]}).to_parquet(pq)
    for reader in ("read_relations_csv", "read_relations_parquet"):
        arg = str(csv) if reader.endswith("csv") else pq
        got, want = getattr(T, reader)(arg), getattr(J, reader)(arg)
        assert [(r.id1, r.id2, r.label) for r in got] == \
            [(r.id1, r.id2, r.label) for r in want] == \
            [("q1", "d1", 1), ("q1", "d2", 0), ("q2", "d3", 1)]
    bad = tmp_path / "bad.csv"
    bad.write_text("q1,d1\n")
    with pytest.raises(ValueError, match="expected id1"):
        T.read_relations_csv(str(bad))
    texts = tmp_path / "texts.csv"
    texts.write_text("a,hello world\nb,the quick, brown fox\n")
    tp = str(tmp_path / "texts.parquet")
    pd.DataFrame({"id": ["a", "b"], "text": ["hello world",
                                             "the quick fox"]}).to_parquet(tp)
    _same_features(J.TextSet.read_csv(str(texts)),
                   T.TextSet.read_csv(str(texts)))
    _same_features(J.TextSet.read_parquet(tp), T.TextSet.read_parquet(tp))


def _corpus(M, n_q=4, n_per_q=3, q_len=4, d_len=6):
    """A seeded question/answer corpus in package ``M``: each question's
    first answer repeats its key token, question 0's first answer is the
    question itself (every token identical)."""
    rng = np.random.default_rng(SEED)
    qs, ds, rels = [], [], []
    for qi in range(n_q):
        q = f"what is key{qi} about topic{qi % 2}"
        qs.append(M.TextFeature(q, uri=f"q{qi}"))
        for ai in range(n_per_q):
            if ai == 0:
                text = q if qi == 0 else f"the answer with key{qi} here"
            else:
                text = f"other words key{int(rng.integers(n_q))} and more"
            ds.append(M.TextFeature(text, uri=f"a{qi}_{ai}"))
            rels.append(M.Relation(f"q{qi}", f"a{qi}_{ai}", int(ai == 0)))
    # one word index over both sides, so no two answers look alike
    vocab = M.TextSet(qs + ds).tokenize().normalize().word2idx() \
        .get_word_index()
    q_set = M.TextSet(qs).tokenize().normalize().word2idx(
        existing_map=vocab)
    d_set = M.TextSet(ds).tokenize().normalize().word2idx(
        existing_map=vocab)
    q_set.shape_sequence(q_len)
    d_set.shape_sequence(d_len)
    return q_set, d_set, rels


def test_relation_pairs_and_lists_match_jax():
    J, T = _text()
    jq, jd, jr = _corpus(J)
    tq, td, tr = _corpus(T)
    for a, b in zip(T.TextSet.from_relation_pairs(tr, tq, td),
                    J.TextSet.from_relation_pairs(jr, jq, jd)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for ga, gb in zip(T.TextSet.from_relation_lists(tr, tq, td),
                      J.TextSet.from_relation_lists(jr, jq, jd),
                      strict=True):
        for a, b in zip(ga, gb):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _knrm_pair(**kw):
    from analytics_zoo_tpu.models import KNRM as J
    from analytics_zoo_tpu_torch.models import KNRM as T

    args = dict(text1_length=4, text2_length=6, vocab_size=30,
                embed_size=8, **kw)
    jm, tm = J(**args), T(**args)
    jm.model.build_params()
    tm.model.build_params()
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, tm.model.get_weights())) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda a: 0, jm.model.params))
    tm.model.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.model.params), device="cpu"))
    return jm, tm


def _pooled_model(net):
    """The sub-model from KNRM's inputs to its kernel-pooling node, on
    ``net``'s weights."""
    node = next(n for n in net._graph.nodes
                if type(n.layer).__name__ == "LambdaOp"
                and len(n.outputs[0].shape) == 2)
    sub = type(net)(net._graph.inputs, node.outputs[0])
    sub.build_params()
    sub.params = {k: net.params[k] for k in sub.params}
    return sub


def _pairs():
    J, T = _text()
    q, d, rels = _corpus(T)
    qa, da, y = T.TextSet.from_relation_pairs(rels, q, d)
    return qa, da, y


@pytest.mark.parametrize("target_mode", ["ranking", "classification"])
def test_knrm_forward_matches_jax(target_mode):
    jm, tm = _knrm_pair(target_mode=target_mode)
    qa, da, _ = _pairs()
    # row 0 pairs question 0 with itself: every cosine on the diagonal is
    # one up to rounding
    assert (qa[0] == da[0][-4:]).all() and qa[0].any()
    x = [qa[:8], da[:8]]
    want = np.asarray(_pooled_model(jm.model).predict(x, batch_size=8))
    got = _pooled_model(tm.model).predict(x, batch_size=8)
    assert got.shape == want.shape == (8, 21)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    want = np.asarray(jm.predict(x, batch_size=8))
    got = tm.predict(x, batch_size=8)
    assert got.shape == want.shape == (8, 1)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_knrm_rank_hinge_step_and_metrics_match_jax(tmp_path):
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    jm, tm = _knrm_pair()
    qa, da, y = _pairs()
    x, y = [qa[:8], da[:8]], y[:8]
    J, T = _text()
    tq, td, tr = _corpus(T)
    groups = T.TextSet.from_relation_lists(tr, tq, td)
    qd, labels = [(g[0], g[1]) for g in groups], [g[2] for g in groups]
    for k in (1, 3):
        assert tm.evaluate_ndcg(qd, labels, k=k) == pytest.approx(
            jm.evaluate_ndcg(qd, labels, k=k), abs=1e-6)
    assert tm.evaluate_map(qd, labels) == pytest.approx(
        jm.evaluate_map(qd, labels), abs=1e-6)
    lr = 1e-2
    before = jax.tree_util.tree_map(np.asarray, jm.model.params)
    jm.compile(optimizer=JAdam(lr), loss="rank_hinge")
    tm.compile(optimizer=Adam(lr), loss="rank_hinge")
    jm.set_tensorboard(str(tmp_path), "zoo")
    jm.fit(x, y, batch_size=8, nb_epoch=1)
    tm.fit(x, y, batch_size=8, nb_epoch=1)
    (jloss,) = {v for _, v, _ in
                jm.model._estimator._writers[0].read_scalar("Loss")}
    ((_, tloss),) = tm.model._estimator.loss_log
    assert tloss == pytest.approx(jloss, rel=TOL)
    for layer, leaves in jm.model.params.items():
        for key, want in leaves.items():
            want = np.asarray(want)
            moved = np.abs(want - before[layer][key]) > 0.5 * lr
            got = tm.model.params[layer][key].numpy()
            assert np.abs(got - want)[moved].max(initial=0.0) <= \
                STEP_TOL * np.abs(want).max(), (layer, key)


def test_knrm_refuses_one_kernel():
    from analytics_zoo_tpu_torch.models import KNRM

    with pytest.raises(ValueError, match="kernel_num"):
        KNRM(4, 6, vocab_size=30, embed_size=8, kernel_num=1)


# WideAndDeep's tree as the private ``_Column`` picker left it, before the
# pickers became ``LambdaOp`` nodes: layer names, leaf names and shapes,
# in order
PRE_SWAP_TREES = {
    "wide": [("wide_linear", "kernel", (17, 2))],
    "deep": [("embed_user", "embeddings", (21, 4)),
             ("embed_item", "embeddings", (31, 3)),
             ("deep_0", "kernel", (13, 8)), ("deep_0", "bias", (8,)),
             ("deep_1", "kernel", (8, 4)), ("deep_1", "bias", (4,)),
             ("deep_head", "kernel", (4, 2)), ("deep_head", "bias", (2,))],
}
PRE_SWAP_TREES["wide_n_deep"] = PRE_SWAP_TREES["wide"] + \
    PRE_SWAP_TREES["deep"]


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_wide_and_deep_tree_unchanged_by_the_lambda_op_pickers(model_type):
    import analytics_zoo_tpu.models as J
    import analytics_zoo_tpu_torch.models as T

    kw = dict(wide_base_cols=["gender", "age_bucket"], wide_base_dims=[2, 5],
              wide_cross_cols=["gender_age"], wide_cross_dims=[10],
              indicator_cols=["genre"], indicator_dims=[4],
              embed_cols=["user", "item"], embed_in_dims=[20, 30],
              embed_out_dims=[4, 3], continuous_cols=["age", "score"])
    jm = J.WideAndDeep(model_type, 2, J.ColumnFeatureInfo(**kw), (8, 4))
    tm = T.WideAndDeep(model_type, 2, T.ColumnFeatureInfo(**kw), (8, 4))
    tm.model.build_params()
    tree = [(layer, key, tuple(t.shape))
            for layer, leaves in tm.model.params.items()
            for key, t in leaves.items()]
    assert tree == PRE_SWAP_TREES[model_type]
    assert tm.model.state == {}
    pickers = [l for l in tm.model.layers
               if type(l).__name__ == "LambdaOp"]
    assert [p.op_name for p in pickers] == (
        [] if model_type == "wide" else ["pick_user", "pick_item"])
    jm.model.build_params()
    tm.model.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.model.params), device="cpu"))
    rng = np.random.default_rng(6)
    rows = {"gender": rng.integers(0, 2, 8),
            "age_bucket": rng.integers(0, 5, 8),
            "gender_age": rng.integers(0, 10, 8),
            "genre": rng.integers(0, 4, 8), "user": rng.integers(0, 21, 8),
            "item": rng.integers(0, 31, 8),
            "age": rng.normal(size=8).astype(np.float32),
            "score": rng.normal(size=8).astype(np.float32)}
    feats = T.to_wide_deep_features(rows, T.ColumnFeatureInfo(**kw))
    feats = feats[:1] if model_type == "wide" else \
        feats[1:] if model_type == "deep" else feats
    want = np.asarray(jm.predict(feats, batch_size=8))
    got = tm.predict(feats, batch_size=8)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
