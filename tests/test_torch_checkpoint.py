"""Checkpoints, resume and retry in the port's estimator.

- A fit resumed mid-epoch by a fresh model and estimator from its
  checkpoints (saved by ``SeveralIteration``, the snapshots after the
  first mid-epoch one dropped, as the reference's own test reaches a
  mid-epoch snapshot) ends bit for bit where the uninterrupted fit ends: its losses from the resume point on, its parameters, its
  optimizer state and its model state (``torch.equal``), at K=1 and K=2
  (the resume point off a K boundary runs the K=1 step).  So does a fit
  whose loader raises once, retried from ``LATEST``.
- ``LATEST`` and the ``.tmp`` protocol, ``keep=3``, the dtype-policy
  guard and ``ZOO_DTYPE_RESUME=cast``, and the allow-list against a
  malicious checkpoint.
- The exchange: a checkpoint the JAX package wrote, resumed by the port,
  and one the port wrote, resumed by the JAX package, each continuing
  within the fit twins' tolerance of the other package's own continuation
  (losses within 1e-5 relative, parameters within 1e-3 relative L2 per
  leaf), for Adam and SGD with momentum.
- ``load_checkpoint``, ``save_weights`` and ``load_weights``.

Bit-for-bit CPU checks run on one thread.  The ``cuda`` cases resume a
captured fit on the card bit for bit, and hold every asynchronous
snapshot against an eager copy of the same step.  The JAX package is
imported inside the exchange tests only, so the ``cuda`` cases run
without it.
"""

import glob
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.pipeline.api.keras import (
    Input,
    Model,
    Sequential,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    BERT,
    BatchNormalization,
    Dense,
    Dropout,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
    _Checkpointer,
)

SEED, BATCH, N = 7, 8, 40   # 5 steps an epoch
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-3
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(autouse=True)
def _restore():
    saved = engine._CONTEXT, torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    engine._CONTEXT = saved[0]
    torch.set_num_threads(saved[1])


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return name


def _net(device, k=1, optimizer=None):
    """An MLP with dropout and BatchNorm on the CPU; on the card a small
    BERT whose attention takes the flash kernels (sequence 256, head dim
    64) with dropout on."""
    init_zoo_context(seed=SEED, device=device, steps_per_dispatch=k)
    if device == "cpu":
        net = Sequential()
        net.add(Dense(16, activation="tanh", input_shape=(6,)))
        net.add(BatchNormalization())
        net.add(Dropout(0.2))
        net.add(Dense(3))
    else:
        ins = [Input((256,)) for _ in range(4)]
        _, pooled = BERT(vocab=100, hidden_size=128, n_block=2, n_head=2,
                         seq_len=256, intermediate_size=256,
                         hidden_p_drop=0.1, attn_p_drop=0.1)(ins)
        net = Model(ins, Dense(3)(pooled))
    net.build_params()
    net.compile(optimizer=optimizer or Adam(1e-2),
                loss="sparse_categorical_crossentropy_from_logits")
    return net


def _data(device, n=N):
    rng = np.random.default_rng(3)
    y = rng.integers(0, 3, n).astype(np.int32)
    if device == "cpu":
        return rng.normal(size=(n, 6)).astype(np.float32), y
    lengths = rng.integers(64, 257, n)
    mask = (np.arange(256)[None, :] < lengths[:, None]).astype(np.float32)
    return [rng.integers(0, 100, (n, 256)).astype(np.int32),
            rng.integers(0, 2, (n, 256)).astype(np.int32),
            np.tile(np.arange(256, dtype=np.int32), (n, 1)), mask], y


def _train(net, fs, ckpt=None, **kw):
    if ckpt is not None:
        net.set_checkpoint(ckpt)
    est = net._make_estimator()
    net._estimator = est
    kw.setdefault("nb_epoch", 2)
    est.train(fs, batch_size=BATCH, **kw)
    return est


def _state_of(net):
    est = net._estimator
    return {"params": net.params, "state": net.state,
            "opt": est._opt_state, "step": est.global_step,
            "epoch": est.epoch}


def _assert_equal(a, b):
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"]
    for key in ("params", "state"):
        for x, y in zip(tree_leaves(a[key]), tree_leaves(b[key]),
                        strict=True):
            assert torch.equal(x, y), key
    for x, y in zip(tree_leaves(tuple(a["opt"])),
                    tree_leaves(tuple(b["opt"])), strict=True):
        assert torch.equal(x, y), "optimizer state"


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("k", [1, 2])
def test_mid_epoch_resume_matches_the_uninterrupted_fit(tmp_path, device,
                                                        k):
    """Saves every 3 steps (off the K boundaries at K=2: at 3, 6, 9 at
    K=1, at 4, 7, 9 at K=2); the snapshots after the first (iteration 3
    or 4, mid-epoch 1) are dropped, as if the process had died there, so
    the third fit resumes at batch 3 or 4 of 5 (K=2: the K=1 tail step
    first)."""
    device = _device(device)
    x, y = _data(device)
    full = _net(device, k)
    _train(full, FeatureSet.of(x, y), str(tmp_path / "a"),
           checkpoint_trigger=SeveralIteration(3))
    want = _state_of(full)
    log = dict(full._estimator.loss_log)
    assert sorted(log) == list(range(1, 11))

    leg1 = _net(device, k)
    ck = str(tmp_path / "b")
    est1 = _train(leg1, FeatureSet.of(x, y), ck,
                  checkpoint_trigger=SeveralIteration(3))
    assert est1.global_step == 10 and est1.epoch == 3
    kept = _drop_snapshots_after_the_first(ck)
    blob = _Checkpointer(ck).latest()
    assert (blob["epoch"], blob["next_batch"]) == (1, kept)
    leg2 = _net(device, k)
    est2 = _train(leg2, FeatureSet.of(x, y), str(tmp_path / "b"),
                  checkpoint_trigger=SeveralIteration(3))
    resumed_at = est2.loss_log[0][0] - 1
    assert resumed_at in (3, 4)
    assert dict(est2.loss_log) == {i: v for i, v in log.items()
                                   if i > resumed_at}
    _assert_equal(_state_of(leg2), want)


def _drop_snapshots_after_the_first(ck) -> int:
    """Removes every snapshot of ``ck`` after the first (a crash right
    after it; ``LATEST`` then names a missing file and the newest file
    left wins); returns the kept one's iteration."""
    tags = sorted(int(f[len("ckpt-"):-len(".pkl")]) for f in os.listdir(ck)
                  if f.startswith("ckpt-") and f.endswith(".pkl"))
    assert len(tags) == 3
    for tag in tags[1:]:
        os.remove(os.path.join(ck, f"ckpt-{tag}.pkl"))
    return tags[0]


def _counting_loader(fail_at):
    calls = []

    def load(path):
        calls.append(path)
        if len(calls) in fail_at:
            raise RuntimeError(f"injected loader fault at load {len(calls)}")
        d = np.load(path)
        return {k: d[k] for k in d.files}
    return load, calls


def _shards(tmp_path, x, y, n=4):
    paths = []
    for i, (xs, ys) in enumerate(zip(np.array_split(x, n),
                                     np.array_split(y, n))):
        p = str(tmp_path / f"shard{i}.npz")
        np.savez(p, x=xs, y=ys)
        paths.append(p)
    return paths


@pytest.mark.parametrize("k", [1, 2])
def test_retry_from_checkpoint_matches_the_uninterrupted_fit(
        tmp_path, monkeypatch, k):
    """A DISK_2 set whose loader raises once in epoch 2: the fit retries
    from ``LATEST`` and ends as the uninterrupted fit does."""
    monkeypatch.setenv("ZOO_FAILURE_RETRY_TIMES", "1")
    x, y = _data("cpu")
    paths = _shards(tmp_path, x, y)
    full = _net("cpu", k)
    _train(full, FeatureSet.from_shards(paths, "DISK_2"),
           str(tmp_path / "a"), checkpoint_trigger=SeveralIteration(3))
    load, calls = _counting_loader({9})
    net = _net("cpu", k)
    est = _train(net, FeatureSet.from_shards(paths, "DISK_2", loader=load),
                 str(tmp_path / "b"),
                 checkpoint_trigger=SeveralIteration(3))
    assert len(calls) > 9  # the fault happened, and the fit went on
    assert dict(est.loss_log) == dict(full._estimator.loss_log)
    assert [h["epoch"] for h in est.history] == [1, 2]
    _assert_equal(_state_of(net), _state_of(full))


def test_retry_budget_spent_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_FAILURE_RETRY_TIMES", "1")
    x, y = _data("cpu")
    paths = _shards(tmp_path, x, y)
    load, _ = _counting_loader({9, 10, 11, 12, 13, 14})
    with pytest.raises(RuntimeError, match="injected loader fault"):
        _train(_net("cpu"), FeatureSet.from_shards(paths, "DISK_2",
                                                   loader=load),
               str(tmp_path / "b"), checkpoint_trigger=SeveralIteration(3))


def test_value_error_is_not_retried(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_FAILURE_RETRY_TIMES", "5")
    x, y = _data("cpu")
    paths = _shards(tmp_path, x, y)
    calls = []

    def load(path):
        calls.append(path)
        if len(calls) == 9:
            raise ValueError("bad shard")
        d = np.load(path)
        return {k: d[k] for k in d.files}

    with pytest.raises(ValueError, match="bad shard"):
        _train(_net("cpu"), FeatureSet.from_shards(paths, "DISK_2",
                                                   loader=load),
               str(tmp_path / "b"), checkpoint_trigger=SeveralIteration(3))
    assert len(calls) == 9


def test_latest_survives_a_leftover_tmp_and_keep_three(tmp_path):
    x, y = _data("cpu")
    net = _net("cpu")
    ck = str(tmp_path / "ck")
    _train(net, FeatureSet.of(x, y), ck, nb_epoch=3,
           checkpoint_trigger=SeveralIteration(2))
    files = sorted(os.path.basename(f) for f in
                   glob.glob(os.path.join(ck, "ckpt-*.pkl")))
    # saves at 2, 4, ..., 14 and at the epoch boundary 10
    assert files == ["ckpt-10.pkl", "ckpt-12.pkl", "ckpt-14.pkl"]
    with open(os.path.join(ck, "LATEST")) as f:
        assert f.read() == "ckpt-14.pkl"
    # a write killed mid-way leaves a .tmp snapshot and pointer behind
    with open(os.path.join(ck, "ckpt-15.pkl.tmp"), "wb") as f:
        f.write(b"\x80\x04truncated")
    with open(os.path.join(ck, "LATEST.tmp"), "w") as f:
        f.write("ckpt-15.pkl")
    blob = _Checkpointer(ck).latest()
    assert blob["global_step"] == 14 and blob["epoch"] == 3
    assert blob["next_batch"] == 4 and blob["seed"] == SEED
    assert blob["plan"]["mesh"] == {"data": 1}
    assert len(blob["plan"]["param_specs"]) == len(
        tree_leaves(net.params))
    assert len(blob["plan"]["opt_specs"]) == len(blob["opt_flat"])


def test_dtype_policy_guard(tmp_path, monkeypatch):
    """A checkpoint saved under bf16 mixed precision refuses an f32
    resume with the reference's message, unless ZOO_DTYPE_RESUME=cast."""
    from analytics_zoo_tpu_torch.parallel import mixed_precision

    x, y = _data("cpu")
    ck = str(tmp_path / "ck")
    _train(_net("cpu"), FeatureSet.of(x, y), ck, nb_epoch=1,
           plan=mixed_precision())
    with pytest.raises(ValueError, match="ZOO_DTYPE_RESUME=cast"):
        _train(_net("cpu"), FeatureSet.of(x, y), ck)
    monkeypatch.setenv("ZOO_DTYPE_RESUME", "cast")
    est = _train(_net("cpu"), FeatureSet.of(x, y), ck)
    assert est.global_step == 10 and est.loss_log[0][0] == 6


def test_malicious_checkpoint_is_refused(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    ck = tmp_path / "ck"
    ck.mkdir()
    with open(ck / "ckpt-1.pkl", "wb") as f:
        pickle.dump({"params": Evil(), "global_step": 1}, f)
    x, y = _data("cpu")
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        _train(_net("cpu"), FeatureSet.of(x, y), str(ck))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        _net("cpu").load_checkpoint(str(ck))


def test_load_checkpoint_reproduces_evaluate(tmp_path):
    x, y = _data("cpu")
    net = _net("cpu")
    net.compile(optimizer=Adam(1e-2),
                loss="sparse_categorical_crossentropy_from_logits",
                metrics=["accuracy"])
    _train(net, FeatureSet.of(x, y), str(tmp_path / "ck"))
    fresh = _net("cpu")
    fresh.compile(optimizer=Adam(1e-2),
                  loss="sparse_categorical_crossentropy_from_logits",
                  metrics=["accuracy"])
    with pytest.raises(FileNotFoundError):
        fresh.load_checkpoint(str(tmp_path / "nothing"))
    fresh.load_checkpoint(str(tmp_path / "ck"))
    assert fresh.evaluate(x, y, batch_size=BATCH) == net.evaluate(
        x, y, batch_size=BATCH)


def test_save_and_load_weights(tmp_path):
    x, y = _data("cpu")
    net = _net("cpu")
    _train(net, FeatureSet.of(x, y), nb_epoch=1)
    path = str(tmp_path / "w.npz")
    net.save_weights(path)
    with pytest.raises(IOError):
        net.save_weights(path, over_write=False)
    fresh = _net("cpu")
    fresh.load_weights(path)
    for a, b in zip(tree_leaves((net.params, net.state)),
                    tree_leaves((fresh.params, fresh.state)), strict=True):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(fresh.predict(x), net.predict(x))


@pytest.mark.parametrize("device", DEVICES)
def test_async_snapshot_equals_an_eager_copy(tmp_path, device):
    """Every asynchronous save of a fit (one each dispatch, the steps
    updating the live buffers in place while the writer runs) holds the
    values of an eager copy taken at the same step, bit for bit."""
    from analytics_zoo_tpu_torch.convert import opt_flat_leaves

    device = _device(device)
    x, y = _data(device)
    net = _net(device, k=2)
    net.set_checkpoint(str(tmp_path / "ck"))
    est = net._make_estimator()
    net._estimator = est
    est._ckpt.keep = 100
    eager = {}
    save = est._ckpt.save

    def spy(tag, payload):
        eager[tag] = tree_map(
            lambda t: t.detach().clone().cpu() if torch.is_tensor(t) else t,
            {k: payload[k] for k in ("params", "state", "opt_flat")})
        return save(tag, payload)

    est._ckpt.save = spy
    est.train(FeatureSet.of(x, y), batch_size=BATCH, nb_epoch=2,
              checkpoint_trigger=SeveralIteration(1))
    assert sorted(eager) == [2, 4, 5, 7, 9, 10]
    for tag, copy in eager.items():
        with open(str(tmp_path / "ck" / f"ckpt-{tag}.pkl"), "rb") as f:
            blob = pickle.load(f)
        for a, b in zip(tree_leaves(copy), tree_leaves(
                {k: blob[k] for k in copy}), strict=True):
            np.testing.assert_array_equal(a.numpy(), b)
    assert len(opt_flat_leaves(est.optimizer, est._opt_state)) == len(
        blob["opt_flat"])


# ---------------------------------------------------------------------------
# the exchange with the JAX package
# ---------------------------------------------------------------------------

def _pair(optimizer, tmp_path):
    """The same MLP in both packages from the JAX package's weights."""
    import jax

    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jkeras
    from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
    from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
    from analytics_zoo_tpu_torch.convert import params_from_jax
    from analytics_zoo_tpu_torch.pipeline.api import keras as tkeras
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers
    from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt

    jax_init(seed=SEED)
    init_zoo_context(seed=SEED, device="cpu")
    nets = []
    for keras, layers, opts in ((jkeras, jlayers, jopt),
                                (tkeras, tlayers, topt)):
        net = keras.Sequential()
        net.add(layers.Dense(32, activation="tanh", input_shape=(12,)))
        net.add(layers.Dense(2))
        opt = (opts.Adam(1e-2) if optimizer == "adam"
               else opts.SGD(0.05, momentum=0.9))
        net.compile(optimizer=opt,
                    loss="sparse_categorical_crossentropy_from_logits")
        net.build_params()
        nets.append(net)
    jnet, tnet = nets
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    jnet.set_tensorboard(str(tmp_path / "tb"), "jax")
    return jnet, tnet


def _jax_losses(jnet):
    return {s: v for s, v, _ in jnet._estimator._writers[0].read_scalar(
        "Loss")}


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_exchange_with_the_jax_package(tmp_path, optimizer,
                                                  writer):
    """One package trains an epoch with a checkpoint, the other resumes
    that checkpoint for a second epoch: its losses and weights follow the
    writer's own second epoch."""
    import jax

    from analytics_zoo_tpu.common import engine as jax_engine

    saved = jax_engine._CONTEXT
    try:
        jnet, tnet = _pair(optimizer, tmp_path)
        rng = np.random.default_rng(1)
        x = rng.normal(size=(48, 12)).astype(np.float32)
        y = rng.integers(0, 2, 48).astype(np.int32)
        src, dst = (jnet, tnet) if writer == "jax" else (tnet, jnet)
        src.set_checkpoint(str(tmp_path / "src"))
        src.fit(x, y, batch_size=8, nb_epoch=1)
        shutil.copytree(tmp_path / "src", tmp_path / "dst")
        src.fit(x, y, batch_size=8, nb_epoch=1)  # the writer's epoch 2
        dst.set_checkpoint(str(tmp_path / "dst"))
        dst.fit(x, y, batch_size=8, nb_epoch=2)  # resumes at epoch 2
        jl = _jax_losses(jnet)
        tl = dict(tnet._estimator.loss_log)
        assert [s for s in sorted(tl) if s > 6] == list(range(7, 13))
        for s in range(7, 13):
            assert tl[s] == pytest.approx(jl[s], rel=LOSS_RTOL), s
        for a, b in zip(tree_leaves(tnet.params),
                        jax.tree_util.tree_leaves(jnet.params)):
            b = np.asarray(b, np.float64)
            err = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
            assert err < PARAM_RTOL
        assert jnet._estimator.global_step == tnet._estimator.global_step \
            == 12
    finally:
        jax_engine._CONTEXT = saved


@pytest.mark.parametrize("name,kwargs", [
    ("Adam", {}), ("Adam", {"decay": 0.01}), ("SGD", {}),
    ("SGD", {"momentum": 0.9}), ("SGD", {"momentum": 0.9, "decay": 0.1}),
    ("SGD", {"momentum": 0.9, "weight_decay": 1e-4}),
    ("AdamWeightDecay", {}), ("AdamWeightDecay", {"total": 100}),
    ("RMSprop", {}), ("Adagrad", {}), ("Adadelta", {}), ("Adamax", {}),
])
def test_opt_flat_is_optax_leaf_order(name, kwargs):
    """``opt_flat_leaves`` of the port's state after two updates is the
    flattened optax state of the reference's optimizer after the same
    updates, leaf for leaf (values within 1e-6), and ``load_opt_flat_``
    writes a reference ``opt_flat`` back into a fresh port state."""
    import jax
    import jax.numpy as jnp

    from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
    from analytics_zoo_tpu_torch.convert import (
        load_opt_flat_,
        opt_flat_leaves,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt

    rng = np.random.default_rng(0)
    shapes = {"b": {"kernel": (3, 4), "bias": (4,)}, "a": {"kernel": (5,)}}
    params = tree_map(lambda s: rng.normal(size=s).astype(np.float32),
                      shapes)
    grads = [tree_map(lambda s: rng.normal(size=s).astype(np.float32),
                      shapes) for _ in range(2)]
    jo, to = getattr(jopt, name)(**kwargs), getattr(topt, name)(**kwargs)
    jp = tree_map(jnp.asarray, params)
    js = jo.init(jp)
    tp = tree_map(torch.from_numpy, params)
    ts = to.init(tp)
    for g in grads:
        upd, js = jo.update(tree_map(jnp.asarray, g), js, jp)
        _, ts = to.update(tree_map(torch.from_numpy, g), ts, tp)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    got = [t.numpy() for t in opt_flat_leaves(to, ts)]
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    fresh = to.init(tree_map(torch.from_numpy, params))
    load_opt_flat_(to, fresh, want, global_step=2)
    assert int(fresh.count) == 2
    for a, b in zip(opt_flat_leaves(to, fresh), want):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("device", DEVICES)
def test_fit_after_warmup_hands_over_the_trained_buffers(device):
    """``warmup`` captures the steps on buffers of its own; a later fit's
    replays update those, and the model must end with the values they
    hold: the K=2 fit after a warmup equals the fit without one."""
    device = _device(device)
    x, y = _data(device)
    plain = _net(device, k=2)
    _train(plain, FeatureSet.of(x, y))
    warm = _net(device, k=2)
    est = warm._make_estimator()
    warm._estimator = est
    est.warmup({"x": x[:BATCH] if device == "cpu"
                else [a[:BATCH] for a in x], "y": y[:BATCH]})
    est.train(FeatureSet.of(x, y), batch_size=BATCH, nb_epoch=2)
    assert est.loss_log == plain._estimator.loss_log
    _assert_equal(_state_of(warm), _state_of(plain))
