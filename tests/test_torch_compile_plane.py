"""The port's compile plane: ``compile_step``'s signature cache and the
``common.compile_cache`` choke point, the per-step randomness as state a
captured step reads, ``fit`` through the K-step dispatch, and
``Estimator.warmup``.

On the CPU the planned step runs eagerly (a CPU has nothing to capture);
what the capture changes is where the randomness and the updates live, and
that is what these tests hold bit for bit against the uncaptured yardstick
(``Estimator.train_step``).  Bit-for-bit comparisons run on one CPU
thread: with several, PyTorch's CPU embedding gradient sums in an order
that changes from run to run.  The ``cuda`` tests hold the captured step
against the eager one on the card.  The JAX package is imported inside
the one test that compares with it, so the ``cuda`` tests run without it.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.common import compile_cache, engine
from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.ops import cuda as ops_cuda
from analytics_zoo_tpu_torch.ops.cuda import build
from analytics_zoo_tpu_torch.parallel import compile_step
from analytics_zoo_tpu_torch.parallel.plan import PlannedStep
from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
from analytics_zoo_tpu_torch.pipeline.estimator.estimator import _to_device

# a small BERT whose attention takes the flash route (sequence 256, head
# dim 64) with hidden and attention dropout on
VOCAB, HIDDEN, BLOCKS, HEADS, INTER, SEQ = 100, 128, 2, 2, 256, 256
SEED, BATCH, DROP = 5, 2, 0.1


@pytest.fixture(autouse=True)
def _restore():
    saved = engine._CONTEXT, torch.get_num_threads()
    compile_cache.reset_compile_stats()
    yield
    engine._CONTEXT = saved[0]
    torch.set_num_threads(saved[1])
    compile_cache.disable_persistent_cache()


@pytest.fixture
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _bert(drop=DROP):
    ins = [Input((SEQ,)) for _ in range(4)]
    _, pooled = BERT(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
                     n_head=HEADS, seq_len=SEQ, intermediate_size=INTER,
                     hidden_p_drop=drop, attn_p_drop=drop)(ins)
    net = Model(ins, Dense(2)(pooled))
    net.build_params()
    net.compile(optimizer=Adam(1e-3),
                loss="sparse_categorical_crossentropy_from_logits")
    return net


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32)
    lengths = rng.integers(SEQ // 4, SEQ + 1, n)
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.float32)
    x = [ids, rng.integers(0, 2, (n, SEQ)).astype(np.int32),
         np.tile(np.arange(SEQ, dtype=np.int32), (n, 1)), mask]
    return x, rng.integers(0, 2, n).astype(np.int32)


def _fit(device, k=None, steps=7, env=None, monkeypatch=None):
    """A fresh BERT fit for ``steps`` steps of one epoch with K from
    ``steps_per_dispatch`` or the environment: (net, per-step losses)."""
    if env is not None:
        monkeypatch.setenv("ZOO_STEPS_PER_DISPATCH", env)
    init_zoo_context(seed=SEED, device=device, steps_per_dispatch=k)
    net = _bert()
    x, y = _data(steps * BATCH)
    net.fit(x, y, batch_size=BATCH, nb_epoch=1)
    return net, [v for _, v in net._estimator.loss_log]


def _eager(device, steps=7):
    """The same training through ``Estimator.train_step`` called step by
    step (the uncaptured yardstick): (params, opt_state, losses)."""
    init_zoo_context(seed=SEED, device=device)
    net = _bert()
    est = net._make_estimator()
    plan = est._resolve_plan()
    step = compile_step(est.train_step, plan, capture=False)
    params = tree_map(torch.clone, net.params)
    opt, state = est.optimizer.init(params), net.state
    casts = est.compute_casts(plan, params)
    x, y = _data(steps * BATCH)
    losses = []
    for i, batch in enumerate(FeatureSet.of(x, y).batches(
            BATCH, shuffle=True, seed=SEED, epoch=1, drop_last=True)):
        params, opt, state, loss = step(
            params, opt, state, engine.step_generator(SEED, i, net.device),
            _to_device(batch, net.device), casts)
        losses.append(loss.item())
    return params, opt, losses


def _equal_trees(a, b):
    return all(torch.equal(u, v) for u, v in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# ---------------------------------------------------------------------------
# the choke point
# ---------------------------------------------------------------------------
def test_signature_cache_counts_misses_and_hits():
    step = compile_step(lambda a, n: a * n, label="toy")
    x = torch.ones(3)
    assert torch.equal(step(x, 2), 2 * x)      # miss
    assert torch.equal(step(x + 1, 2), 4 * x)  # hit: same signature
    step(torch.ones(4), 2)                     # miss: a new shape
    step(x.double(), 2)                        # miss: a new dtype
    step(x, 3)                                 # miss: a scalar is by value
    stats = compile_cache.compile_stats()["toy"]
    assert (stats["misses"], stats["hits"]) == (4, 1)
    assert len(stats["seconds"]) == 4  # each first call timed on the CPU
    assert len(step._exes) == 4


def test_signature_cache_evicts_the_oldest_at_32():
    step = compile_step(lambda a: a.sum(), label="churn")
    for n in range(1, 34):
        step(torch.ones(n))
    assert len(step._exes) == PlannedStep._MAX_EXES == 32
    step(torch.ones(33))  # still cached
    step(torch.ones(1))   # evicted: a miss again
    stats = compile_cache.compile_stats()["churn"]
    assert (stats["misses"], stats["hits"]) == (34, 1)


def test_signature_keys_structure_and_keyword_arguments():
    seen = []
    step = compile_step(lambda t, scale=1.0: seen.append(scale), label="kw")
    step({"a": torch.ones(2)}, scale=2.0)
    step({"a": torch.ones(2)}, scale=2.0)
    step({"b": torch.ones(2)}, scale=2.0)  # another key: another signature
    step([torch.ones(2)], scale=2.0)
    assert seen == [2.0] * 4
    assert compile_cache.compile_stats()["kw"]["misses"] == 3


def test_kernel_step_and_labels():
    fn = lambda t: t + 1  # noqa: E731
    step = ops_cuda.kernel_step("toy", fn)
    assert step is ops_cuda.kernel_step("toy", fn)
    assert step.label == "kernel_toy"
    step(torch.zeros(2))
    assert compile_cache.compile_stats()["kernel_toy"]["misses"] == 1
    assert compile_step(fn, "dp+bf16").label == "dp+bf16_step"


def test_persistent_cache_points_the_kernel_libraries(tmp_path, monkeypatch):
    assert build.build_dir() == build.BUILD_DIR
    monkeypatch.setenv("ZOO_COMPILE_CACHE", str(tmp_path / "env"))
    assert build.library_path("fused_adam").parent == tmp_path / "env"
    explicit = compile_cache.maybe_enable_persistent_cache(
        str(tmp_path / "explicit"))
    assert build.library_path("fused_adam").parent == tmp_path / "explicit"
    assert compile_cache.maybe_enable_persistent_cache() == explicit
    compile_cache.disable_persistent_cache()
    monkeypatch.delenv("ZOO_COMPILE_CACHE")
    assert build.build_dir() == build.BUILD_DIR


def test_counters_move_back_and_forth():
    from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as fx

    before = ops_cuda.counter_snapshot()
    fx.fwd_launch_count += 2
    delta = ops_cuda.counter_delta(before, ops_cuda.counter_snapshot())
    assert delta == {("fused_softmax_xent", "fwd_launch_count"): 2}
    ops_cuda.add_counters(delta, -1)
    assert ops_cuda.counter_snapshot() == before
    ops_cuda.add_counters(delta)
    assert fx.fwd_launch_count == before[delta.popitem()[0]] + 2
    fx.fwd_launch_count -= 2


# ---------------------------------------------------------------------------
# the per-step randomness as device state
# ---------------------------------------------------------------------------
def _forward(net, x, rng):
    return net.forward(net.params, x, state=net.state, training=True,
                       rng=rng)[0]


@pytest.mark.parametrize("steps", [(0, 1), (3, 7, 8)], ids=["0-1", "3-7-8"])
def test_step_keys_give_todays_masks_at_every_site(steps, one_thread):
    """A dispatch's keys give every dropout site the generator, and every
    flash call the seed pair, that today's per-step generator tree gives
    it: eagerly, and from the persistent state a capture reads after
    ``reseed`` (generators re-seeded, pairs written to the buffer)."""
    init_zoo_context(seed=SEED, device="cpu")
    net = _bert()
    x = [torch.from_numpy(a[:BATCH]) for a in _data(BATCH)[0]]
    src = engine.StepRandomness("cpu", k=1)
    record = src.keys(SEED, steps[0])
    first = _forward(net, x, record[0])
    assert torch.equal(first, _forward(net, x, engine.step_generator(
        SEED, steps[0])))
    gens, pairs = record.run[0]
    # embedding, two hidden sites a block; one attention site a block
    assert len(gens) == 1 + 2 * BLOCKS and len(pairs) == BLOCKS
    state = src.prepare_capture(record)
    persistent = state.generators()
    assert len(persistent) == len(gens)
    for step in steps:
        keys = src.keys(SEED, step)
        src.reseed(keys, state)
        root = engine.step_generator(SEED, step)
        for gen, path in zip(persistent, gens):
            want = root
            for data in path:
                want = engine.fold_in(want, data)
            assert gen.initial_seed() == want.initial_seed()
        for i, path in enumerate(pairs):
            want = root
            for data in path:
                want = engine.fold_in(want, data)
            got = state.pairs[0, i].numpy().view(np.uint32)
            assert tuple(int(v) for v in got) == engine.seed_pair(want)
        with src.capturing(state):
            served = _forward(net, x, keys[0])
        assert torch.equal(served, _forward(net, x, root))


def test_step_randomness_refuses_changed_sites():
    """A capture must make the requests of the eager run before it, in
    order; each distinct set of sites (another batch shape can take
    another attention route) gets its own persistent state."""
    src = engine.StepRandomness("cpu", k=2)
    keys = src.keys(1, 0)
    engine.generator_of(engine.fold_in(keys[1], 4))
    keys[0].flash_seed()
    state = src.prepare_capture(keys)
    assert src.prepare_capture(keys) is state
    assert state.pairs.shape == (2, 1, 2) and len(state.generators()) == 1
    with pytest.raises(RuntimeError, match="random sites changed"):
        with src.capturing(state):
            engine.generator_of(engine.fold_in(keys[1], 5))
    with pytest.raises(RuntimeError, match="fewer random requests"):
        with src.capturing(state):
            engine.generator_of(engine.fold_in(keys[1], 4))
    other = src.keys(1, 0)
    engine.generator_of(engine.fold_in(other[0], 7))
    dense = src.prepare_capture(other)
    assert dense is not state and dense.pairs.shape == (2, 0, 2)
    with src.capturing(dense):
        gen = engine.generator_of(engine.fold_in(other[0], 7))
    assert gen is dense.generators()[0]


def test_flash_seed_tensors_stay_on_their_device():
    """normalize_seed passes a device seed through without a host copy."""
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as tfa

    pair = torch.tensor([3, -4], dtype=torch.int32)
    assert tfa.normalize_seed(pair) is pair
    one = tfa.normalize_seed(torch.tensor([7], dtype=torch.int64))
    assert one.dtype == torch.int32 and one.tolist() == [7, 0]
    q, k, v = (torch.randn(1, 1, 256, 64) for _ in range(3))
    host = tfa.attention_reference(q, k, v, False, 0.125, dropout_p=0.1,
                                   seed=(3, 2 ** 32 - 4))
    dev = tfa.attention_reference(q, k, v, False, 0.125, dropout_p=0.1,
                                  seed=pair)
    assert torch.equal(host, dev)


# ---------------------------------------------------------------------------
# fit through the K-step dispatch
# ---------------------------------------------------------------------------
def test_steps_per_dispatch_is_validated(monkeypatch):
    for bad in ("0", "-2", "two"):
        monkeypatch.setenv("ZOO_STEPS_PER_DISPATCH", bad)
        with pytest.raises(ValueError, match="ZOO_STEPS_PER_DISPATCH"):
            init_zoo_context(seed=1, device="cpu")
    monkeypatch.setenv("ZOO_STEPS_PER_DISPATCH", "4")
    assert init_zoo_context(seed=1, device="cpu").steps_per_dispatch == 4
    assert init_zoo_context(seed=1, device="cpu",
                            steps_per_dispatch=2).steps_per_dispatch == 2
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        init_zoo_context(seed=1, device="cpu", steps_per_dispatch=0)


def test_fit_is_the_eager_step_bit_for_bit(one_thread):
    """fit's in-place dispatch against train_step called step by step,
    dropout 0.1 at every site: losses, parameters and Adam state."""
    net, losses = _fit("cpu", k=1)
    params, opt, eager_losses = _eager("cpu")
    assert losses == eager_losses
    assert _equal_trees(net.params, params)
    assert _equal_trees(net._estimator._opt_state, opt)
    stats = compile_cache.compile_stats()["train_step"]
    assert (stats["misses"], stats["hits"]) == (1, 6)


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_fit_with_k_3_is_k_1_bit_for_bit(how, one_thread, monkeypatch):
    """Seven steps as two dispatches of three and a K=1 tail give the K=1
    trajectory: inner step i takes global step step0 + i."""
    net1, l1 = _fit("cpu", k=1)
    if how == "argument":
        net3, l3 = _fit("cpu", k=3)
    else:
        net3, l3 = _fit("cpu", env="3", monkeypatch=monkeypatch)
    assert net3._estimator.ctx.steps_per_dispatch == 3
    assert l3 == l1 and len(l1) == 7
    assert _equal_trees(net3.params, net1.params)
    assert _equal_trees(net3._estimator._opt_state,
                        net1._estimator._opt_state)
    stats = compile_cache.compile_stats()
    assert (stats["train_step_scan3"]["misses"],
            stats["train_step_scan3"]["hits"]) == (1, 1)
    # the tail of the K=3 fit: one K=1 dispatch (after seven in the K=1 fit)
    assert stats["train_step"]["misses"] + stats["train_step"]["hits"] == 8


def test_fit_leaves_the_callers_tensors_and_continues_in_place(one_thread):
    init_zoo_context(seed=SEED, device="cpu")
    net = _bert()
    before = net.params
    kept = tree_map(torch.clone, before)
    x, y = _data(2 * BATCH)
    net.fit(x, y, batch_size=BATCH, nb_epoch=1)
    assert _equal_trees(before, kept)  # the model's old tensors untouched
    trained = net.params
    assert not _equal_trees(trained, kept)
    net.fit(x, y, batch_size=BATCH, nb_epoch=1)
    assert net.params is trained  # the second fit continued in place
    est = net._estimator
    assert est.global_step == 4 and len(est.loss_log) == 4


def test_fit_with_k_matches_the_jax_package(monkeypatch, tmp_path):
    """Seven steps at K=3 in both packages (an MLP: no dropout, as the
    training parity tests have it): every step's loss within 1e-5
    relative, parameters within 1e-3 relative L2 per leaf
    (test_torch_bert_training's tolerances)."""
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.common import engine as jax_engine
    from analytics_zoo_tpu.pipeline.api import keras as jkeras
    from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.convert import params_from_jax
    from analytics_zoo_tpu_torch.pipeline.api import keras as tkeras
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers

    saved = jax_engine._CONTEXT
    monkeypatch.setenv("ZOO_STEPS_PER_DISPATCH", "3")
    try:
        jax_init(seed=SEED)
        init_zoo_context(seed=SEED, device="cpu")
        nets = []
        for keras, layers, adam in ((jkeras, jlayers, JAdam),
                                    (tkeras, tlayers, Adam)):
            net = keras.Sequential()
            net.add(layers.Dense(32, activation="tanh", input_shape=(12,)))
            net.add(layers.Dense(2))
            net.compile(optimizer=adam(1e-2),
                        loss="sparse_categorical_crossentropy_from_logits")
            net.build_params()
            nets.append(net)
        jnet, tnet = nets
        import jax

        tnet.set_weights(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
        rng = np.random.default_rng(1)
        x = rng.normal(size=(56, 12)).astype(np.float32)
        y = rng.integers(0, 2, 56).astype(np.int32)
        jnet.set_tensorboard(str(tmp_path), "k3")
        for net in nets:
            net.fit(x, y, batch_size=8, nb_epoch=1)
        jl = {s: v for s, v, _ in
              jnet._estimator._writers[0].read_scalar("Loss")}
        tl = dict(tnet._estimator.loss_log)
        assert sorted(tl) == sorted(jl) == list(range(1, 8))
        np.testing.assert_allclose([tl[s] for s in range(1, 8)],
                                   [jl[s] for s in range(1, 8)], rtol=1e-5)
        assert compile_cache.compile_stats()["train_step_scan3"][
            "misses"] == 1
        for a, b in zip(tree_leaves(tnet.params),
                        jax.tree_util.tree_leaves(jnet.params)):
            b = np.asarray(b, np.float64)
            err = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
            assert err < 1e-3
    finally:
        jax_engine._CONTEXT = saved


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------
def test_warmup_returns_the_labels_and_leaves_the_model(one_thread):
    init_zoo_context(seed=SEED, device="cpu", steps_per_dispatch=3)
    net = _bert()
    est = net._make_estimator()
    net._estimator = est
    kept = tree_map(torch.clone, net.params)
    x, y = _data(BATCH)
    out = est.warmup({"x": x, "y": y})
    assert sorted(out) == ["train_step", "train_step_scan3"]
    assert all(s > 0 for s in out.values())
    assert _equal_trees(net.params, kept)
    assert est._opt_state is None and est.global_step == 0
    assert sorted(est.warmup({"x": x, "y": y}, steps_per_dispatch=1)) == [
        "train_step"]
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        est.warmup({"x": x, "y": y}, steps_per_dispatch=0)
    # a fit after warmup hits the warmed steps and trains from the model's
    # own weights: the trajectory of a fit with no warmup
    net.fit(*_data(6 * BATCH), batch_size=BATCH, nb_epoch=1)
    stats = compile_cache.compile_stats()
    assert stats["train_step_scan3"]["misses"] == 1
    _, losses = _fit("cpu", k=3, steps=6)
    assert [v for _, v in est.loss_log] == losses


# ---------------------------------------------------------------------------
# on the card: the captured step
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_captured_fit_is_the_eager_step_bit_for_bit(cuda_device):
    """fit replays one captured graph a step (dropout 0.1 at every site);
    five steps equal train_step called eagerly, bit for bit; K=3 equals
    K=1."""
    net, losses = _fit("cuda", k=1, steps=5)
    params, opt, eager_losses = _eager("cuda", steps=5)
    assert losses == eager_losses
    assert _equal_trees(net.params, params)
    assert _equal_trees(net._estimator._opt_state, opt)
    net3, l3 = _fit("cuda", k=3, steps=5)
    assert l3 == losses and _equal_trees(net3.params, net.params)


@pytest.mark.cuda
def test_launch_counts_hold_under_replay(cuda_device):
    from analytics_zoo_tpu_torch.ops.cuda import kernel_invocation_counts

    init_zoo_context(seed=SEED, device="cuda")
    net = _bert()
    x, y = _data(4 * BATCH)
    net.fit([a[:BATCH] for a in x], y[:BATCH], batch_size=BATCH,
            nb_epoch=1)  # the eager step and the capture
    before = kernel_invocation_counts()
    net.fit(x, y, batch_size=BATCH, nb_epoch=1)  # four replays
    after = kernel_invocation_counts()
    moved = {k: after[k]["kernel"] - before[k]["kernel"] for k in after}
    # every other imported kernel (the int8 matmul) moves no time
    assert moved == {**dict.fromkeys(moved, 0),
                     "flash_attention_fwd": 4 * BLOCKS,
                     "flash_attention_bwd": 4 * BLOCKS, "fused_adam": 4,
                     "softmax_xent_fwd": 4, "softmax_xent_bwd": 4}
    assert compile_cache.compile_stats()["train_step"]["hits"] == 4
