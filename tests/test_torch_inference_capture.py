"""Inference through the port's compile plane, against the JAX package.

The same model is built in both packages (a 2-block BERT of hidden 64, one
head of dim 64, sequence 128, and the Dense ``Sequential`` of
``tests/test_torch_precision.py``); the port takes the reference's
weights through ``params_from_jax`` and both get the same numpy inputs,
made from a seed.

- ``KerasNet.predict`` (the ``predict_step`` program) and
  ``predict_classes`` against the reference's, in f32 within 1e-5 (both
  compute in f32; they differ in summation order) and with the context's
  compute dtype bf16 within 1e-3 (the two frameworks round bf16
  intermediates at different places), over a tail batch;
- ``summary``: the reference's table, line for line;
- the per-batch ``evaluate`` (``Estimator.eval_step`` through
  ``compile_step``, the sums outside it): within 1e-5 of the reference's
  and equal bit for bit to the port's earlier loop (the whole pass in one
  uncaptured step, kept here as the yardstick); under
  ``mixed_precision()`` within the bf16 tolerance of
  ``tests/test_torch_precision.py`` (1e-2 relative) of the reference's;
- ``InferenceModel``'s compile counts: one miss per bucket under
  ``inference_b<bucket>``, hits after that, and ``optimize`` and
  ``from_keras_net`` drop every capture;
- arguments passed by reference are neither cloned nor copied; concurrent
  ``predict`` calls on one bucket return their own answers;
- ``load_torch`` and ``enable_persistent_compile_cache`` as the
  reference's.

On the CPU every planned step runs eagerly.  The ``cuda`` tests hold a
replay against the eager run on the card; the JAX package is imported
inside the tests that compare with it, so they run without it.
"""

import threading

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import init_zoo_context as torch_init
from analytics_zoo_tpu_torch.common import compile_cache
from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.parallel import compile_step
from analytics_zoo_tpu_torch.parallel.plan import _sig, _static_leaves

VOCAB, HIDDEN, BLOCKS, HEADS, INTER, SEQ = 100, 64, 2, 1, 128, 128
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
LOSS_RTOL_BF16 = 1e-2  # tests/test_torch_precision.py's LOSS_RTOL
EVAL_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _restore():
    import analytics_zoo_tpu_torch.common.engine as torch_engine

    saved = torch_engine._CONTEXT
    compile_cache.reset_compile_stats()
    yield
    torch_engine._CONTEXT = saved
    compile_cache.disable_persistent_cache()


@pytest.fixture
def jax_context():
    """The JAX package's global context, left as found."""
    import analytics_zoo_tpu.common.engine as jax_engine

    saved = jax_engine._CONTEXT
    yield
    jax_engine._CONTEXT = saved


def _bert(keras, layers, head="softmax"):
    ins = [keras.Input((SEQ,)) for _ in range(4)]
    _, pooled = layers.BERT(
        vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS, n_head=HEADS,
        seq_len=SEQ, intermediate_size=INTER, hidden_p_drop=0.0,
        attn_p_drop=0.0)(ins)
    return keras.Model(ins, layers.Dense(2, activation=head)(pooled))


def _dense(keras, layers):
    m = keras.Sequential()
    m.add(layers.Dense(16, activation="relu", input_shape=(8,)))
    m.add(layers.Dense(4, activation="softmax"))
    return m


def _bert_data(n, seed=1):
    gen = np.random.default_rng(seed)
    ids = gen.integers(0, VOCAB, (n, SEQ)).astype(np.int32)
    types = gen.integers(0, 2, (n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    lengths = gen.integers(SEQ // 4, SEQ + 1, n)
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.float32)
    return [ids, types, pos, mask], gen.integers(0, 2, n).astype(np.int32)


def _dense_data(n, seed=0):
    gen = np.random.default_rng(seed)
    x = gen.normal(size=(n, 8)).astype(np.float32)
    return x, gen.integers(0, 4, n).astype(np.int32)


def _pair(build, compute_dtype=None):
    """The same model in both packages, the port's with the reference's
    weights, both contexts in ``compute_dtype``."""
    import jax

    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jk
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    jax_init(seed=3, compute_dtype=compute_dtype)
    torch_init(seed=3, device="cpu", compute_dtype=compute_dtype)
    jnet, tnet = build(jk, jl), build(tk, tl)
    jnet.build_params()
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    return jnet, tnet


# ---------------------------------------------------------------------------
# KerasNet.predict, predict_classes, summary
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model,dtype", [
    ("bert", None), ("bert", "bf16"), ("dense", None), ("dense", "bf16")])
def test_keras_predict_matches_jax(model, dtype, jax_context):
    build, data = {"bert": (_bert, _bert_data),
                   "dense": (_dense, _dense_data)}[model]
    jnet, tnet = _pair(build, dtype)
    x, _ = data(11)
    tol = BF16_TOL if dtype else F32_TOL
    # batches of 8 and a tail of 3 (the reference pads each batch to its
    # 8-device mesh and keeps the padded rows of a batch short of 8)
    got = tnet.predict(x, batch_size=8)
    want = np.asarray(jnet.predict(x, batch_size=8))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    classes = tnet.predict_classes(x, batch_size=8)
    np.testing.assert_array_equal(classes, np.argmax(got, axis=-1))
    np.testing.assert_array_equal(
        tnet.predict_classes(x, batch_size=8, zero_based_label=False),
        classes + 1)
    if dtype is None:  # bf16 probabilities may sit on either side of a tie
        np.testing.assert_array_equal(
            classes, np.asarray(jnet.predict_classes(x, batch_size=8)))
    # one program per batch shape (the batch of 8 and the tail of 3),
    # replayed by the two predict_classes calls
    stats = compile_cache.compile_stats()["predict_step"]
    assert (stats["misses"], stats["hits"]) == (2, 4)


def test_keras_predict_step_is_dropped_with_the_weights():
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    torch_init(seed=3, device="cpu")
    net = _dense(tk, tl)
    x, _ = _dense_data(4)
    first = net.predict(x, batch_size=4)
    step = net._predict_fn[1]
    assert net.predict(x, batch_size=4).tolist() == first.tolist()
    assert net._predict_fn[1] is step  # cached
    net.set_weights({k: {n: 2 * w for n, w in v.items()}
                     for k, v in net.get_weights().items()})
    assert net._predict_fn is None
    assert not np.array_equal(net.predict(x, batch_size=4), first)


@pytest.mark.parametrize("model", ["bert", "dense"])
def test_summary_matches_reference(model, capsys, jax_context):
    jnet, tnet = _pair({"bert": _bert, "dense": _dense}[model])
    want = jnet.summary()
    got = tnet.summary()
    assert got.splitlines() == want.splitlines()
    assert capsys.readouterr().out == want + "\n" + got + "\n"


# ---------------------------------------------------------------------------
# the per-batch eval step
# ---------------------------------------------------------------------------
def _earlier_loop(est, params, state, val_set, batch_size, casts):
    """The port's eval loop before the per-batch step: the whole pass in
    one uncaptured step, the casts made once, the statistics summed on the
    device (the yardstick the per-batch step must equal bit for bit)."""
    from analytics_zoo_tpu_torch.common.engine import cast_floats
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _cast_params,
        _to_device,
    )

    def loop(params, state, val_set, batch_size, casts):
        device = est.model.device
        casts = casts or (None, est.ctx.compute_dtype)
        accum = None
        with torch.no_grad():
            pc = _cast_params(params, casts)
            for batch in val_set.batches(batch_size, shuffle=False,
                                         drop_last=False, pad_to_batch=1):
                n_valid = int(batch["n_valid"])
                batch = _to_device(batch, device)
                preds, _ = est.model.forward(
                    pc, cast_floats(batch["x"], casts[1]), state=state,
                    training=False)
                preds = cast_floats(preds, torch.float32)
                mask = (torch.arange(preds.shape[0]) < n_valid).float()
                stats = [((est.loss(batch["y"], preds) * mask).sum(),
                          mask.sum())]
                for m in est.metrics:
                    stats.append(m.batch_stats(batch["y"], preds, mask=mask))
                accum = stats if accum is None else [
                    [a + b for a, b in zip(ga, gb)]
                    for ga, gb in zip(accum, stats)]
        results = {"loss": float(accum[0][0]) / max(float(accum[0][1]),
                                                    1e-12)}
        for i, m in enumerate(est.metrics):
            results[m.name] = m.finalize([float(s) for s in accum[i + 1]])
        return results

    return compile_step(loop, est._resolve_plan(), capture=False)(
        params, state, val_set, batch_size, casts)


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_evaluate_per_batch_matches_jax_and_the_earlier_loop(mixed,
                                                             jax_context):
    from analytics_zoo_tpu.feature.dataset import FeatureSet as JFS
    from analytics_zoo_tpu.parallel.plan import mixed_precision as jmp
    from analytics_zoo_tpu.pipeline.api.keras.metrics import (
        get_metric as jget_metric,
    )
    from analytics_zoo_tpu.pipeline.api.keras.objectives import (
        get_loss as jget_loss,
    )
    from analytics_zoo_tpu.pipeline.estimator import Estimator as JEst
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.parallel import mixed_precision
    from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import (
        get_metric,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        get_loss,
    )
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator

    torch.set_num_threads(1)
    loss = "sparse_categorical_crossentropy_from_logits"
    jnet, tnet = _pair(lambda k, l: _bert(k, l, head=None))
    x, y = _bert_data(10)  # batches of 4, 4 and a tail of 2
    jest = JEst(jnet, loss=jget_loss(loss), metrics=[jget_metric("accuracy")],
                plan=jmp() if mixed else None)
    test = Estimator(tnet, loss=get_loss(loss),
                     metrics=[get_metric("accuracy")],
                     plan=mixed_precision() if mixed else None)
    want = jest.evaluate(JFS.of(x, y), batch_size=4)
    got = test.evaluate(FeatureSet.of(x, y), batch_size=4)
    rtol = LOSS_RTOL_BF16 if mixed else EVAL_RTOL
    assert got["loss"] == pytest.approx(float(want["loss"]), rel=rtol)
    if not mixed:  # bf16 logits may sit on either side of a tie
        assert got["accuracy"] == pytest.approx(float(want["accuracy"]))
    plan = test._resolve_plan()
    assert got == _earlier_loop(test, tnet.params, tnet.state,
                                FeatureSet.of(x, y), 4,
                                test.compute_casts(plan, tnet.params))
    # one program per batch shape: the batch of 4 and the tail of 2
    stats = compile_cache.compile_stats()["eval_step"]
    assert (stats["misses"], stats["hits"]) == (2, 1)
    assert test.evaluate(FeatureSet.of(x, y), batch_size=4) == got
    assert compile_cache.compile_stats()["eval_step"]["hits"] == 4


def test_validation_in_fit_runs_the_eval_step():
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    torch_init(seed=3, device="cpu")
    net = _dense(tk, tl)
    net.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                metrics=["accuracy"])
    x, y = _dense_data(64)
    net.fit(x, y, batch_size=16, nb_epoch=2, validation_data=(x, y))
    assert compile_cache.compile_stats()["eval_step"] == {
        "seconds": compile_cache.compile_stats()["eval_step"]["seconds"],
        "misses": 1, "hits": 7}  # 2 validations x 4 batches
    res = net.evaluate(x, y, batch_size=16)
    assert 0.0 <= res["accuracy"] <= 1.0 and np.isfinite(res["loss"])


# ---------------------------------------------------------------------------
# InferenceModel through the compile plane
# ---------------------------------------------------------------------------
def _serving_model():
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    torch_init(seed=3, device="cpu")
    net = _bert(tk, tl)
    net.build_params()
    return net, InferenceModel().from_keras_net(net)


def _counts(label):
    row = compile_cache.compile_stats().get(label, {})
    return row.get("misses", 0), row.get("hits", 0)


def test_inference_compile_counts_per_bucket():
    net, im = _serving_model()
    im.warmup([(SEQ,)] * 4, dtype=[np.int32] * 3 + [np.float32],
              batch_sizes=(1, 3, 8))
    assert [_counts(f"inference_b{b}") for b in (1, 2, 4, 8)] == \
        [(1, 0), (0, 0), (1, 0), (1, 0)]
    x, _ = _bert_data(11)
    im.predict(x, batch_size=4)  # 4 + 4 + 3: bucket 4 three times
    im.predict([a[:1] for a in x])
    assert [_counts(f"inference_b{b}") for b in (1, 4, 8)] == \
        [(1, 1), (1, 3), (1, 0)]
    assert sorted(im._buckets.values()) == [1, 4, 8]
    # optimize and from_keras_net drop every capture: misses again
    im.optimize("bf16")
    assert im._buckets == {} and im._steps == {}
    im.predict([a[:3] for a in x])
    assert _counts("inference_b4") == (2, 3)
    im.from_keras_net(net)
    im.predict([a[:3] for a in x])
    assert _counts("inference_b4") == (3, 3)


def test_inference_predict_matches_the_eager_forward():
    net, im = _serving_model()
    x, _ = _bert_data(3)
    padded = [np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)])
              for a in x]
    with torch.no_grad():
        want, _ = net.forward(net.params, [torch.from_numpy(a)
                                           for a in padded],
                              state=net.state)
    np.testing.assert_array_equal(im.predict(x), want.numpy()[:3])
    empty = im.predict([a[:0] for a in x])
    assert empty.shape == (0, 2) and empty.dtype == np.float32


def test_concurrent_predicts_on_one_bucket_return_their_own_answers():
    _, im = _serving_model()
    reqs = [_bert_data(8, seed=s)[0] for s in range(4)]
    want = [im.predict(r) for r in reqs]
    got = {i: [] for i in range(4)}
    start = threading.Barrier(4)

    def send(i):
        start.wait()
        for _ in range(5):
            got[i].append(im.predict(reqs[i]))

    threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(4):
        assert len(got[i]) == 5
        for out in got[i]:
            np.testing.assert_array_equal(out, want[i])
    assert im.bucket_stats[8]["runs"] == 24


def test_arguments_by_reference_are_neither_cloned_nor_copied():
    w, d, x = torch.ones(3), torch.zeros(3), torch.arange(3.0)
    static = _static_leaves((w, d, x), {}, donate_argnums=(1,),
                            ref_argnums=(0,))
    assert static[0][0] is w and static[1][0] is d
    assert static[2][0] is not x and torch.equal(static[2][0], x)
    with torch.inference_mode():
        inf = torch.ones(2)
        copied = _static_leaves((inf,), {}, (), ())[0][0]
    assert not copied.is_inference()  # a replay can copy into it
    # a by-reference argument keys on its buffer: another buffer is another
    # signature, the same buffer a hit whatever its values
    step = compile_step(lambda w, x: w * x, label="by_ref", ref_argnums=(0,))
    assert torch.equal(step(w, x), x)
    w.mul_(2)
    assert torch.equal(step(w, x + 1), 2 * (x + 1))
    assert torch.equal(step(w.clone(), x), 2 * x)
    assert _counts("by_ref") == (2, 1)
    assert _sig(w, True) != _sig(w.clone(), True)
    assert _sig(w) == _sig(w.clone())


def test_load_torch_matches_reference():
    from analytics_zoo_tpu.pipeline.inference.inference_model import (
        InferenceModel as JaxIM,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    lin = torch.nn.Linear(4, 2)
    x = np.random.default_rng(5).normal(size=(5, 4)).astype(np.float32)
    want = JaxIM().load_torch(lin, input_shape=(4,)).predict(x,
                                                            batch_size=2)
    got = InferenceModel().load_torch(lin, input_shape=(4,))
    np.testing.assert_array_equal(got.predict(x, batch_size=2), want)
    empty = got.predict(x[:0])
    assert empty.shape == (0, 2) and empty.dtype == np.float32
    assert not lin.training


def test_enable_persistent_compile_cache_matches_reference(tmp_path):
    from analytics_zoo_tpu.common import compile_cache as jcc
    from analytics_zoo_tpu.pipeline.inference.inference_model import (
        InferenceModel as JaxIM,
    )
    from analytics_zoo_tpu_torch.ops.cuda import build
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    path = str(tmp_path / "cache")
    try:
        JaxIM.enable_persistent_compile_cache(path)
        InferenceModel.enable_persistent_compile_cache(path)
        assert compile_cache.cache_dir() == jcc.cache_dir()
        assert build.library_path("fused_adam").parent == tmp_path / "cache"
        # a no-argument call keeps the explicit directory, in both
        assert compile_cache.maybe_enable_persistent_cache() == \
            jcc.maybe_enable_persistent_cache()
    finally:
        jcc.disable_persistent_cache()


# ---------------------------------------------------------------------------
# on the card: a replay against the eager run
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replay_reads_by_reference_arguments_in_place(cuda_device):
    w = torch.ones(64, device=cuda_device)
    x = torch.arange(64.0, device=cuda_device)
    step = compile_step(lambda w, x: w * x + 1, label="by_ref_cuda",
                        ref_argnums=(0,))
    assert torch.equal(step(w, x), x + 1)  # the eager run of the capture
    exe = next(iter(step._exes.values()))
    assert exe.static[0][0] is w and exe.static[1][0] is not x
    w.mul_(3)
    with step.lock:
        assert torch.equal(step(w, x + 2), 3 * (x + 2) + 1)  # a replay
    assert _counts("by_ref_cuda") == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8", "int8_cal"])
def test_inference_replay_equals_the_eager_forward(precision, cuda_device):
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    torch_init(seed=3, device="cuda")
    if precision == "int8_cal":
        ids = tk.Input((SEQ,))
        _, pooled = tl.BERT(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
                            n_head=HEADS, seq_len=SEQ,
                            intermediate_size=INTER)(ids)
        net = tk.Model(ids, tl.Dense(2, activation="softmax")(pooled))
    else:
        net = _bert(tk, tl)
    net.build_params()
    im = InferenceModel().from_keras_net(net)
    x, _ = _bert_data(8)
    if precision == "int8_cal":
        x = x[0]
        im.optimize("int8", calibration_data=x)
    elif precision != "f32":
        im.optimize(precision)
    xs = x if isinstance(x, list) else [x]
    want = im._forward_fn()(im._params, im._state,
                            [torch.from_numpy(a).to(cuda_device)
                             for a in xs]).cpu().numpy()
    for _ in range(3):  # the capture's eager run, then replays
        np.testing.assert_array_equal(im.predict(x), want)
    assert _counts("inference_b8") == (1, 2)
