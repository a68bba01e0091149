"""The port's tfpark estimators against the JAX package's.

At the tiny BERT of the reference's tests (vocab 50, hidden 16, one
block of two heads, 12 tokens, dropout 0) each BERT estimator starts from
the JAX package's weights: its two steps' losses agree within 1e-5
relative and its predictions within 1e-5.  ``steps=`` counts whole
epochs in both, the spec errors are the same, clipping acts alike, a
warm-start archive written by either package warm-starts the other, and a
``model_dir`` checkpoint written by the JAX package resumes in the port
on the reference's own trajectory.  One JAX run per estimator is shared
by the file.
"""

import shutil

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu import init_zoo_context as jax_context
from analytics_zoo_tpu.tfpark import estimator as jest
from analytics_zoo_tpu.tfpark.text import estimator as jbert
from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.common.utils import tree_leaves
from analytics_zoo_tpu_torch.convert import params_from_jax, sorted_leaves
from analytics_zoo_tpu_torch.tfpark import estimator as pest
from analytics_zoo_tpu_torch.tfpark.text import estimator as pbert

SEQ = 12
TINY = dict(vocab=50, hidden_size=16, n_block=1, n_head=2, seq_len=SEQ,
            intermediate_size=32, hidden_p_drop=0.0, attn_p_drop=0.0)
REL = 1e-5


def _ids(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 50, size=(n, SEQ)).astype(np.int32)


def _labels(kind, ids):
    if kind == "classifier":
        return (ids[:, 0] % 3).astype(np.int32)
    if kind == "ner":
        return (ids % 4).astype(np.int32)
    starts = ids[:, 0] % (SEQ - 2)
    return np.stack([starts, starts + 1], axis=1).astype(np.int32)


def _make(pkg, kind, **kw):
    mod = jbert if pkg == "jax" else pbert
    args = dict(TINY, optimizer="adam")
    args.update(kw)
    if kind == "classifier":
        return mod.BERTClassifier(num_classes=3, dropout=0.0, **args)
    if kind == "ner":
        return mod.BERTNER(num_entities=4, dropout=0.0, **args)
    return mod.BERTSquad(**args)


def _record_estimators(est):
    """Keep each ``train``'s Estimator (its history and step count)."""
    made = []
    orig = est._training_estimator

    def keep():
        e = orig()
        made.append(e)
        return e

    est._training_estimator = keep
    return made


def _jax_weights(est, input_fn):
    est._ensure_built(est._to_feature_set(input_fn()), "train")
    params, state = est._train_net.build_params()
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


def _port_with(est, input_fn, weights):
    est._ensure_built(est._to_feature_set(input_fn()), "train")
    est._train_net.build_params(device="cpu")
    est._train_net.params = params_from_jax(weights[0], "cpu")
    est._train_net.state = params_from_jax(weights[1], "cpu")


def _jax_run(kind, clip=None):
    jax_context(seed=42)
    ids = _ids(32)
    y = _labels(kind, ids)
    input_fn = jbert.bert_input_fn({"input_ids": ids, "labels": y}, SEQ)
    # clipping by the global norm shows under SGD (Adam's step is scale
    # free)
    est = _make("jax", kind, **({"optimizer": "sgd"} if clip else {}))
    if clip:
        est.set_gradient_clipping_by_l2_norm(clip)
    made = _record_estimators(est)
    weights = _jax_weights(est, input_fn)
    est.train(input_fn, steps=2, batch_size=32)
    preds = est.predict(input_fn)
    return {"ids": ids, "y": y, "weights": weights,
            "losses": [h["loss"] for h in made[0].history],
            "steps": made[0].global_step, "preds": preds,
            # one evaluate is enough to hold the port's against
            "eval": est.evaluate(input_fn, ["accuracy"])
            if kind == "classifier" else None}


@pytest.fixture(scope="module")
def reference():
    """One JAX run per estimator (and one clipped classifier run)."""
    return {kind: _jax_run(kind) for kind in ("classifier", "ner", "squad")} \
        | {"clipped": _jax_run("classifier", clip=0.05)}


@pytest.fixture(autouse=True)
def _cpu():
    init_zoo_context(seed=42, device="cpu")


@pytest.mark.parametrize("kind", ["classifier", "ner", "squad", "clipped"])
def test_two_steps_and_predictions_match_reference(reference, kind):
    ref = reference[kind]
    if kind == "clipped":
        est = _make("port", "classifier", optimizer="sgd")
        est.set_gradient_clipping_by_l2_norm(0.05)
    else:
        est = _make("port", kind)
    input_fn = pbert.bert_input_fn({"input_ids": ref["ids"],
                                    "labels": ref["y"]}, SEQ)
    made = _record_estimators(est)
    _port_with(est, input_fn, ref["weights"])
    est.train(input_fn, steps=2, batch_size=32)
    losses = [h["loss"] for h in made[0].history]
    assert made[0].global_step == ref["steps"] == 2
    np.testing.assert_allclose(losses, ref["losses"], rtol=REL)
    preds = est.predict(input_fn)
    if kind == "squad":
        for got, want in zip(preds, ref["preds"]):
            np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(preds[0].sum(-1), 1.0, atol=1e-5)
    else:
        np.testing.assert_allclose(preds, ref["preds"], atol=1e-5)
    if ref["eval"] is not None:
        out = est.evaluate(input_fn, ["accuracy"])
        assert out["accuracy"] == pytest.approx(ref["eval"]["accuracy"])
        assert out["loss"] == pytest.approx(ref["eval"]["loss"], rel=REL)


def test_clipping_changes_the_trajectory(reference):
    ref = reference["clipped"]
    input_fn = pbert.bert_input_fn({"input_ids": ref["ids"],
                                    "labels": ref["y"]}, SEQ)
    est = _make("port", "classifier", optimizer="sgd")
    made = _record_estimators(est)
    _port_with(est, input_fn, ref["weights"])
    est.train(input_fn, steps=2, batch_size=32)
    unclipped = made[0].history[1]["loss"]
    assert ref["losses"][1] != pytest.approx(unclipped, rel=1e-4)
    est.set_constant_gradient_clipping(-0.1, 0.1)
    assert est._grad_clip == ("const", -0.1, 0.1)
    est.clear_gradient_clipping()
    assert est._grad_clip is None


def test_steps_count_whole_epochs_in_both():
    ids = _ids(64)
    y = _labels("classifier", ids)
    counts = []
    for pkg, mod in (("jax", jbert), ("port", pbert)):
        (jax_context if pkg == "jax" else init_zoo_context)(
            seed=42, **({} if pkg == "jax" else {"device": "cpu"}))
        est = _make(pkg, "classifier")
        made = _record_estimators(est)
        est.train(mod.bert_input_fn({"input_ids": ids, "labels": y}, SEQ),
                  steps=3, batch_size=32)
        counts.append(made[0].global_step)
    assert counts == [4, 4]  # steps=3 over 2-step epochs ends epoch 2


def _spec_error(mod, *args, **kwargs):
    with pytest.raises((ValueError, TypeError)) as e:
        mod.TFEstimatorSpec(*args, **kwargs)
    return type(e.value), str(e.value)


def test_spec_errors_match_reference():
    for args, kwargs in ((("train",), {}), (("eval",), {"loss": None}),
                         (("predict",), {}),
                         (("predict",), {"predictions": np.zeros(2)})):
        assert _spec_error(pest, *args, **kwargs) == \
            _spec_error(jest, *args, **kwargs)
    est = pest.TFEstimator(lambda f, l, m, p: None)
    with pytest.raises(TypeError, match="TFEstimatorSpec"):
        est.train(lambda: (np.zeros((4, 3), np.float32),
                           np.zeros(4, np.int32)), steps=1)
    with pytest.raises(ValueError, match="optimizer"):
        pest.TFEstimator(_linear_model_fn).train(
            lambda: (np.zeros((4, 3), np.float32), np.zeros(4, np.int32)),
            batch_size=4)


def _linear_model_fn(features, labels, mode, params):
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    probs = Dense(2, activation="softmax")(features)
    if labels is None:
        return pest.TFEstimatorSpec(mode, predictions=probs)
    return pest.TFEstimatorSpec(mode, predictions=probs,
                                loss=pest.sparse_ce(probs, labels))


def test_generic_model_fn_trains_and_predicts():
    x = np.random.default_rng(4).normal(size=(64, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    est = pest.TFEstimator(_linear_model_fn,
                           optimizer=pest.ZooOptimizer(Adam(lr=0.05)))
    est.train(lambda: (x, y), steps=40, batch_size=16)
    assert est.evaluate(lambda: (x, y), ["accuracy"])["accuracy"] > 0.8
    assert est.predict(lambda: x).shape == (64, 2)
    # the predict net holds the train net's trained tensors
    shared = [k for k in est._pred_net.params if k in est._train_net.params]
    assert shared and all(
        est._pred_net.params[k]["kernel"] is est._train_net.params[k][
            "kernel"] for k in shared)


def _head_model_fn(features, labels, mode, params):
    """Logits on the loss path; a second Dense only on the predictions
    path."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    probs = Dense(2, activation="softmax")(features)
    head = Dense(3)(probs)
    if labels is None:
        return pest.TFEstimatorSpec(mode, predictions=head)
    return pest.TFEstimatorSpec(mode, predictions=head,
                                loss=pest.sparse_ce(probs, labels))


def test_predict_only_layers_draw_as_build_params():
    """After ``train`` the predict net holds the train net's tensors for
    the layers they share, and a layer only on the predictions path what
    the predict net's own ``build_params`` draws for it."""
    from analytics_zoo_tpu_torch.common.engine import make_generator
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    x = np.random.default_rng(5).normal(size=(32, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    est = pest.TFEstimator(_head_model_fn,
                           optimizer=pest.ZooOptimizer(Adam(lr=0.05)))
    est.train(lambda: (x, y), steps=2, batch_size=16)
    pred, train = est._pred_net, est._train_net
    only = [k for k in pred.params if k not in train.params]
    shared = [k for k in pred.params if k in train.params]
    assert only and shared
    drawn = pred.init_params(make_generator(42))
    for k in only:
        for a, b in zip(tree_leaves(pred.params[k]), tree_leaves(drawn[k])):
            assert torch.equal(a, b)
    for k in shared:
        assert all(a is b for a, b in zip(tree_leaves(pred.params[k]),
                                          tree_leaves(train.params[k])))
    assert est.predict(lambda: x).shape == (32, 3)


def _encoder(est):
    return [t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
            for t in sorted_leaves(est._train_net.params[est.bert.name])]


def test_warm_start_archives_cross_packages(reference, tmp_path):
    ref = reference["classifier"]
    ids, y = ref["ids"], ref["y"]
    # JAX archive -> port classifier and port SQuAD encoder
    jax_context(seed=42)
    jfn = jbert.bert_input_fn({"input_ids": ids, "labels": y}, SEQ)
    j = _make("jax", "classifier")
    j._ensure_built(j._to_feature_set(jfn()), "train")
    j._train_net.build_params()
    jpath = str(tmp_path / "jax_init.npz")
    j.save_init_checkpoint(jpath)
    want = [np.asarray(a) for a in
            jax.tree_util.tree_leaves(j._train_net.params[j.bert.name])]
    init_zoo_context(seed=7, device="cpu")
    pfn = pbert.bert_input_fn({"input_ids": ids, "labels": y}, SEQ)
    for kind, fn in (("classifier", pfn), ("squad", pbert.bert_input_fn(
            {"input_ids": ids, "labels": _labels("squad", ids)}, SEQ))):
        p = _make("port", kind, init_checkpoint=jpath)
        p._ensure_built(p._to_feature_set(fn()), "train")
        got = _encoder(p)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # port archive (after training) -> JAX classifier
    p = _make("port", "classifier")
    p.train(pfn, steps=1, batch_size=32)
    ppath = str(tmp_path / "port_init.npz")
    p.save_init_checkpoint(ppath)
    jax_context(seed=42)
    j2 = _make("jax", "classifier", init_checkpoint=ppath)
    j2._ensure_built(j2._to_feature_set(jfn()), "train")
    got = [np.asarray(a) for a in
           jax.tree_util.tree_leaves(j2._train_net.params[j2.bert.name])]
    for a, b in zip(got, _encoder(p)):
        np.testing.assert_array_equal(a, b)
    # an archive of another architecture matches nothing
    other = str(tmp_path / "other.npz")
    np.savez(other, **{"bert_0/0": np.zeros((3, 3), np.float32)})
    bad = _make("port", "classifier", init_checkpoint=other)
    with pytest.raises(ValueError, match="matches none"):
        bad._ensure_built(bad._to_feature_set(pfn()), "train")
    assert len(tree_leaves(p._train_net.params[p.bert.name])) == len(want)


def test_model_dir_resume_from_either_package(reference, tmp_path):
    ref = reference["classifier"]
    ids, y = ref["ids"], ref["y"]
    md = str(tmp_path / "jax_md")
    jax_context(seed=42)
    jfn = jbert.bert_input_fn({"input_ids": ids, "labels": y}, SEQ)
    j = _make("jax", "classifier", model_dir=md)
    _jax_weights(j, jfn)
    j._train_net.params = jax.tree_util.tree_map(
        jax.numpy.asarray, ref["weights"][0])
    j.train(jfn, steps=2, batch_size=32)
    shutil.copytree(md, str(tmp_path / "jax_md_copy"))
    # the reference continues its own checkpoint for two more steps ...
    j2 = _make("jax", "classifier", model_dir=md)
    jmade = _record_estimators(j2)
    j2.train(jfn, steps=4, batch_size=32)
    # ... and the port continues the same checkpoint the same way
    init_zoo_context(seed=42, device="cpu")
    pfn = pbert.bert_input_fn({"input_ids": ids, "labels": y}, SEQ)
    p = _make("port", "classifier", model_dir=str(tmp_path / "jax_md_copy"))
    pmade = _record_estimators(p)
    p.train(pfn, steps=4, batch_size=32)
    assert pmade[0].global_step == jmade[0].global_step == 4
    np.testing.assert_allclose(
        [h["loss"] for h in pmade[0].history if h["loss"] is not None],
        [h["loss"] for h in jmade[0].history if h["loss"] is not None],
        rtol=REL)
    np.testing.assert_allclose(p.predict(pfn), j2.predict(jfn), atol=1e-5)
    # a port checkpoint resumes in a fresh port estimator
    p2 = _make("port", "classifier", model_dir=str(tmp_path / "jax_md_copy"))
    pmade2 = _record_estimators(p2)
    p2.train(pfn, steps=5, batch_size=32)
    assert pmade2[0].global_step == 5
