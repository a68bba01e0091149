"""The text-matching path through the compile plane: captured steps against
eager ones.

No JAX here, so the ``cuda`` cases run on a machine without it.  On the
CPU a fit runs eagerly and every check holds as stated; on the card step 1
is eager and captured and the later steps replay the CUDA graph:

- KNRM (``rank_hinge``; its kernel pooling and cosine matrix are
  ``LambdaOp`` nodes), ``IntentEntity`` fitting its two heads on a list of
  two labels, and a graph that adds a trainable ``Parameter`` and a
  frozen one, each trained through ``fit``, give the losses, parameters,
  Adam moments and model state of ``Estimator.train_step`` called
  eagerly, bit for bit; the frozen ``Parameter`` is unchanged;
- ``index_select`` out of range gives NaN and a negative index wraps, on
  the card with no device-side assert;
- a lookup whose ids repeat heavily (the NER character table's 24,576 ids
  over 100 rows) has a table gradient that is the same bit for bit on
  every run.

Bit-for-bit CPU checks run on one thread.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.common.engine import step_generator
from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.parallel import compile_step
from analytics_zoo_tpu_torch.pipeline.estimator.estimator import _to_device

SEED, BATCH, STEPS = 19, 8, 3
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


def _knrm(device):
    from analytics_zoo_tpu_torch.models import KNRM

    init_zoo_context(seed=SEED, device=device)
    m = KNRM(5, 12, vocab_size=100, embed_size=16)
    m.model.build_params()
    m.compile(optimizer="adam", loss="rank_hinge")
    rng = np.random.default_rng(1)
    q = rng.integers(0, 100, (BATCH * STEPS, 5)).astype(np.int32)
    d = rng.integers(0, 100, (BATCH * STEPS, 12)).astype(np.int32)
    d[::2, :5] = q[::2]  # every positive repeats its query's tokens
    y = np.tile([1.0, 0.0], BATCH * STEPS // 2).astype(np.float32)[:, None]
    return m.model, [q, d], y


def _intent_entity(device):
    from analytics_zoo_tpu_torch.tfpark.text.keras import IntentEntity

    init_zoo_context(seed=SEED, device=device)
    m = IntentEntity(num_intents=3, num_entities=5, word_vocab_size=50,
                     char_vocab_size=20, word_length=4, seq_len=6,
                     word_emb_dim=8, char_emb_dim=4, char_lstm_dim=4,
                     tagger_lstm_dim=8)
    m.model.build_params()
    rng = np.random.default_rng(2)
    n = BATCH * STEPS
    words = rng.integers(1, 50, (n, 6)).astype(np.int32)
    chars = rng.integers(1, 20, (n, 6, 4)).astype(np.int32)
    return m.model, [words, chars], [(words[:, 0] % 3).astype(np.int32),
                                     (words % 5).astype(np.int32)]


def _parameter_graph(device):
    from analytics_zoo_tpu_torch.pipeline.api.autograd import (
        AutoGrad,
        Parameter,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    init_zoo_context(seed=SEED, device=device)
    x = Input(shape=(6,))
    h = Dense(4)(x) + Parameter((4,), name="shift")()
    out = AutoGrad.l2_normalize(h * Parameter((4,), trainable=False,
                                              name="scale")())
    net = Model(x, out)
    net.build_params()
    net.compile(optimizer="adam", loss="mse")
    rng = np.random.default_rng(3)
    return (net, rng.normal(size=(BATCH * STEPS, 6)).astype(np.float32),
            rng.normal(size=(BATCH * STEPS, 4)).astype(np.float32))


def _eager(net, x, y):
    """``train_step`` called step by step over one epoch's batches, from
    the net's weights: (params, Adam state, model state, losses)."""
    est = net._make_estimator()
    plan = est._resolve_plan(None)
    step = compile_step(est.train_step, plan, capture=False)
    params = tree_map(torch.clone, net.params)
    opt = est.optimizer.init(params)
    state = tree_map(torch.clone, net.state)
    casts = est.compute_casts(plan, params)
    losses = []
    for i, b in enumerate(FeatureSet.of(x, y).batches(
            BATCH, shuffle=True, seed=SEED, epoch=1, drop_last=True)):
        params, opt, state, loss = step(
            params, opt, state, step_generator(SEED, i, net.device),
            _to_device(b, net.device), casts)
        losses.append(float(loss))
    return params, opt, state, losses


def _trained(net):
    return (net.params, net._estimator._opt_state, net.state,
            [v for _, v in net._estimator.loss_log])


def _assert_same(a, b):
    assert a[3] == b[3]
    for x, y in zip(tree_leaves((a[0], tuple(a[1]), a[2])),
                    tree_leaves((b[0], tuple(b[1]), b[2])), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("make", [_knrm, _intent_entity, _parameter_graph],
                         ids=["knrm", "intent_entity", "parameters"])
@pytest.mark.parametrize("device", DEVICES)
def test_captured_step_is_the_eager_step(device, make):
    net, x, y = make(_device(device))
    frozen = tree_map(torch.clone, net.state)
    want = _eager(net, x, y)
    net.fit(x, y, batch_size=BATCH, nb_epoch=1)
    got = _trained(net)
    _assert_same(got, want)
    assert all(np.isfinite(got[3]))
    if make is _parameter_graph:
        assert set(net.params) == {"dense_0", "shift"}
        assert torch.equal(net.state["scale"]["value"],
                           frozen["scale"]["value"])


@pytest.mark.parametrize("device", DEVICES)
def test_index_select_out_of_range_on_the_device(device):
    from analytics_zoo_tpu_torch.pipeline.api.autograd import take

    dev = _device(device)
    x = torch.arange(24, dtype=torch.float32, device=dev).reshape(2, 3, 4)
    got = [take(x, i, 2) for i in (-1, 3, 4, -5)]
    if dev == "cuda":
        torch.cuda.synchronize()  # a device-side assert would raise here
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  got[1].cpu().numpy())
    assert torch.isnan(got[2]).all() and torch.isnan(got[3]).all()
    assert float((x + 1).sum()) == 300.0  # the context still works


@pytest.mark.parametrize("device", DEVICES)
def test_heavily_repeated_lookup_is_reproducible(device):
    """24,576 ids over a 100-row table (the NER character table's shape):
    the chunked gather gives ``F.embedding``'s rows bit for bit, its table
    gradient within 1e-5 of the unchunked one's largest entry, and the
    same gradient bit for bit on every run."""
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding import (
        CHUNK_IDS,
        REPEATS,
        lookup,
    )

    dev = _device(device)
    gen = torch.Generator().manual_seed(5)
    table = torch.randn(100, 30, generator=gen).to(dev)
    ids = torch.randint(0, 100, (32, 768), generator=gen).to(dev)
    g = torch.randn(32, 768, 30, generator=gen).to(dev)
    assert ids.numel() > CHUNK_IDS and ids.numel() > REPEATS * 100

    def grad(fn):
        t = table.clone().requires_grad_()
        out = fn(t)
        (gt,) = torch.autograd.grad(out, t, g)
        return out.detach(), gt

    rows, want = grad(lambda t: F.embedding(ids, t))
    got_rows, got = grad(lambda t: lookup(t, ids))
    assert torch.equal(got_rows, rows)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for _ in range(3):
        assert torch.equal(grad(lambda t: lookup(t, ids))[1], got)
