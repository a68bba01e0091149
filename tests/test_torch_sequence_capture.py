"""The sequence path through the compile plane: captured steps against
eager ones, remat inside a fit, and the embedding's ids on the device.

No JAX here, so the ``cuda`` cases run on a machine without it.  On the
CPU a fit runs eagerly and every check holds as stated; on the card
(``cuda`` cases) step 1 is eager and captured and the later steps replay
the CUDA graph:

- a TextClassifier (LSTM encoder) and an MoE TransformerLayer classifier
  (dropout 0.1; on the card at sequence 256 and head dim 64, the flash
  route) trained through ``fit`` give the losses, parameters and Adam
  moments of ``Estimator.train_step`` called eagerly, bit for bit;
- the MoE classifier under ``remat`` ``"full"``, ``"dots"`` and ``"attn"``
  trains bit for bit as under ``remat=None`` (inside the capture on the
  card: the recompute redraws the forward's dropout masks from the step's
  registered generators and seed pairs);
- out-of-range embedding ids give NaN rows and negative ids wrap, on the
  card without a device-side assert.

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
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Dense,
    GlobalAveragePooling1D,
    TransformerLayer,
)
from analytics_zoo_tpu_torch.pipeline.estimator.estimator import _to_device

SEED, BATCH, STEPS = 13, 8, 3
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


def _text_classifier(device):
    from analytics_zoo_tpu_torch.models import TextClassifier

    init_zoo_context(seed=SEED, device=device)
    tc = TextClassifier(3, 16, sequence_length=24, encoder="lstm",
                        encoder_output_dim=32, vocab_size=100)
    tc.model.build_params()
    tc.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               metrics=["accuracy"])
    rng = np.random.default_rng(1)
    x = rng.integers(0, 100, size=(BATCH * STEPS, 24)).astype(np.int32)
    return tc.model, x, rng.integers(0, 3, BATCH * STEPS).astype(np.int32)


def _moe_classifier(device, remat=None):
    init_zoo_context(seed=SEED, device=device)
    seq, hidden = (16, 16) if device == "cpu" else (256, 128)
    net = Sequential()
    net.add(TransformerLayer(
        vocab=50, seq_len=seq, n_block=2, n_head=2, hidden_size=hidden,
        moe_experts=4, moe_top_k=2, remat=remat, hidden_drop=0.1,
        attn_drop=0.1, embedding_drop=0.1, input_shape=(seq,)))
    net.add(GlobalAveragePooling1D())
    net.add(Dense(2))
    net.build_params()
    net.compile(optimizer="adam",
                loss="sparse_categorical_crossentropy_from_logits")
    rng = np.random.default_rng(2)
    x = rng.integers(0, 50, size=(BATCH * STEPS, seq)).astype(np.int32)
    return net, x, rng.integers(0, 2, BATCH * STEPS).astype(np.int32)


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


@pytest.mark.parametrize("device", DEVICES)
def test_captured_lstm_step_is_the_eager_step(device):
    net, x, y = _text_classifier(_device(device))
    want = _eager(net, x, y)
    net.fit(x, y, batch_size=BATCH, nb_epoch=1)
    _assert_same(_trained(net), want)


@pytest.mark.parametrize("device", DEVICES)
def test_captured_moe_step_is_the_eager_step(device):
    net, x, y = _moe_classifier(_device(device))
    want = _eager(net, x, y)
    net.fit(x, y, batch_size=BATCH, nb_epoch=1)
    got = _trained(net)
    _assert_same(got, want)
    (moe,) = [v for v in got[2].values() if "moe_aux_cost" in v]
    assert float(moe["moe_aux_loss"]) > 0.0


@pytest.mark.parametrize("device", DEVICES)
def test_remat_policies_train_bit_for_bit(device):
    dev = _device(device)
    base, x, y = _moe_classifier(dev)
    base.fit(x, y, batch_size=BATCH, nb_epoch=1)
    want = _trained(base)
    for policy in ("full", "dots", "attn"):
        net, _, _ = _moe_classifier(dev, remat=policy)
        net.fit(x, y, batch_size=BATCH, nb_epoch=1)
        _assert_same(_trained(net), want)


@pytest.mark.parametrize("device", DEVICES)
def test_embedding_ids_out_of_range(device):
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding import (
        lookup,
    )

    dev = _device(device)
    table = torch.arange(12, dtype=torch.float32, device=dev).reshape(4, 3)
    ids = torch.tensor([[0, 3, 4, -1, -4, -5, 100]], device=dev)
    rows = lookup(table, ids)
    if dev == "cuda":
        torch.cuda.synchronize()  # a device-side assert would raise here
    rows = rows.cpu()
    np.testing.assert_array_equal(rows[0, [0, 1, 3, 4]].numpy(),
                                  table.cpu()[[0, 3, 3, 0]].numpy())
    assert torch.isnan(rows[0, [2, 5, 6]]).all()
    assert float((table + 1).sum()) == 78.0  # the context still works
