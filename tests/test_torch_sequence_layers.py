"""The port's embedding, recurrent and advanced-activation layers against
the JAX package's.

Each case builds one layer in both packages, gives both the same numpy
parameters (through ``params_from_jax``, nested trees included:
``Bidirectional``'s ``{"fwd", "bwd"}``, ``TimeDistributed``'s
``{"inner"}``) and inputs, and holds the port's forward and its autograd
gradients (of every parameter and of the input, under one seeded
cotangent) against the reference's forward and ``jax.grad``.  Errors are
the largest absolute difference relative to the reference's largest
magnitude.  Tolerances:

- 0 (bit for bit) for the embedding lookup's forward, NaN rows included,
  and 1e-6 for its gradient (a scatter-add whose order may differ);
- 1e-5 for the advanced activations, forward and gradient;
- 2e-5 for the recurrent layers' forward and 1e-4 for their gradients:
  the port hoists every timestep's input product out of the time loop and
  sums ``(x·W + b) + h·U`` where the reference sums ``(x·W + h·U) + b``,
  and a gradient goes back through every timestep;
- 1e-4 for ConvLSTM2D/3D, forward and gradient (the input convolution of
  every timestep as one convolution, the bias added to it first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

ACT_TOL = 1e-5
RNN_FWD_TOL, RNN_GRAD_TOL = 2e-5, 1e-4
CONV_LSTM_TOL = 1e-4


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nest of dicts and lists, keys sorted."""
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


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _leaves(tree).items()}


def _random_like(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda v: (scale * rng.normal(size=v.shape)).astype(np.float32),
        tree)


def _run(make, x, seed=0, scale=0.5, params=None):
    """(forward error, {leaf path or "x": gradient error}) of the layer
    ``make(module)`` builds, on input ``x``, with random parameters of the
    reference's tree (or ``params``)."""
    jlayer, tlayer = make(jl), make(tl)
    jlayer.ensure_built(x.shape[1:])
    tlayer.ensure_built(x.shape[1:])
    rng = np.random.default_rng(seed)
    init = jlayer.init_params(jax.random.PRNGKey(0))
    assert _shapes(tlayer.init_params(torch.Generator().manual_seed(0))) \
        == _shapes(init)
    if params is None:
        params = _random_like(init, rng, scale)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jx = jnp.asarray(x)
    shape = jax.eval_shape(jlayer.call, jp, jx).shape
    cot = rng.normal(size=shape).astype(np.float32)

    def forward_and_vjp(p, v, c):  # one compile for both
        out, vjp = jax.vjp(jlayer.call, p, v)
        return out, vjp(c)

    want, jg = jax.jit(forward_and_vjp)(jp, jx, jnp.asarray(cot))
    want = np.asarray(want)
    tp = tree_map(lambda t: t.requires_grad_(),
                  params_from_jax(params, device="cpu"))
    tx = torch.tensor(x, requires_grad=True)
    got = tlayer.call(tp, tx)
    errs = {"forward": _err(got.detach().numpy(), want)}
    (got * torch.from_numpy(cot)).sum().backward()
    tgrads = _leaves(tree_map(lambda t: t.grad, tp))
    for path, g in _leaves(jg[0]).items():
        errs[path] = _err(tgrads[path].numpy(), g)
    errs["x"] = _err(tx.grad.numpy(), jg[1])
    return errs


# ---------------------------------------------------------------------------
# advanced activations
# ---------------------------------------------------------------------------

ADVANCED = {
    "LeakyReLU": ((), {"alpha": 0.2}),
    "ELU": ((), {"alpha": 0.7}),
    "ThresholdedReLU": ((), {"theta": 0.5}),
    "PReLU": ((), {}),
    "ParametricSoftPlus": ((), {"alpha_init": 0.3, "beta_init": 2.0}),
    "SReLU": ((), {}),
}


@pytest.mark.parametrize("name", sorted(ADVANCED))
def test_advanced_activation_matches_jax(name):
    """Forward and gradients within 1e-5 on inputs holding the boundary
    values (0 and theta) exactly; the deterministic initial values (PReLU's
    0.25, ParametricSoftPlus's alpha and beta, SReLU's t_left 0 and a_right
    1) equal the reference's."""
    args, kwargs = ADVANCED[name]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1] = 0.5
    errs = _run(lambda m: getattr(m, name)(*args, **kwargs), x)
    assert max(errs.values()) <= ACT_TOL, errs
    jlayer, tlayer = (getattr(m, name)(*args, **kwargs) for m in (jl, tl))
    jlayer.ensure_built((5, 4))
    tlayer.ensure_built((5, 4))
    jinit = _leaves(jlayer.init_params(jax.random.PRNGKey(0)))
    tinit = _leaves(tlayer.init_params(torch.Generator().manual_seed(0)))
    for path in ("/alpha", "/beta", "/t_left", "/a_right"):
        if path in jinit:
            np.testing.assert_array_equal(tinit[path].numpy(),
                                          np.asarray(jinit[path]))


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Embedding", "SparseEmbedding"])
def test_embedding_matches_jax(name):
    """Out-of-range ids give the reference's NaN rows and negative ids wrap
    (-1 is the last row; -n the first; -(n+1) a NaN row): the forward bit
    for bit, NaNs in the same places; the table's gradient within 1e-6,
    the NaN rows' cotangents dropped as ``jnp.take``'s VJP drops them."""
    n, d = 7, 5
    ids = np.array([[0, 3, 6, 7, 10], [-1, -7, -8, 2, 2]], np.int32)
    jlayer, tlayer = (getattr(m, name)(n, d) for m in (jl, tl))
    jlayer.ensure_built((5,))
    tlayer.ensure_built((5,))
    rng = np.random.default_rng(2)
    table = rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(jlayer.call({"embeddings": jnp.asarray(table)},
                                  jnp.asarray(ids)))
    tp = params_from_jax({"embeddings": table}, device="cpu")
    tp["embeddings"].requires_grad_()
    got = tlayer.call(tp, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert np.isnan(want[0, 3]).all() and np.isnan(want[1, 2]).all()
    np.testing.assert_array_equal(want[1, 0], table[-1])
    cot = rng.normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jnp.where(
        jnp.isnan(jlayer.call({"embeddings": t}, jnp.asarray(ids))), 0.0,
        jlayer.call({"embeddings": t}, jnp.asarray(ids)) * cot)))(
            jnp.asarray(table))
    got.masked_fill(torch.isnan(got), 0.0).mul(torch.from_numpy(cot)) \
        .sum().backward()
    assert _err(tp["embeddings"].grad.numpy(), jg) <= 1e-6


def test_frozen_embedding_lives_in_state():
    """``trainable=False`` with pretrained weights: no parameter, the table
    in state, the call returns (rows, state) as the reference's does."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[1, 3, -1]], np.int32)
    jlayer, tlayer = (m.Embedding(4, 3, weights=table, trainable=False)
                      for m in (jl, tl))
    jlayer.ensure_built((3,))
    tlayer.ensure_built((3,))
    assert tlayer.stateful and jlayer.stateful
    assert tlayer.init_params(torch.Generator().manual_seed(0)) == {}
    state = tlayer.init_state()
    np.testing.assert_array_equal(state["embeddings"].numpy(), table)
    want, _ = jlayer.call({}, jnp.asarray(ids),
                          state=jlayer.init_state())
    got, new_state = tlayer.call({}, torch.from_numpy(ids), state=state)
    assert new_state is state
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_word_embedding_from_a_glove_file(tmp_path):
    """A GloVe-format file with a word2vec header line and a multi-token
    word: the same word index, table and pretrained count as the
    reference's parser, and the same lookups."""
    lines = ["5 3", "the 0.1 0.2 0.3", "cat -1.0 2.5 0.0",
             ". . . 0.5 0.5 0.5", "dog 1e-3 -2 4", "4.5 7 8 9"]
    path = tmp_path / "vectors.txt"
    path.write_text("\n".join(lines) + "\n")
    word_index = {"the": 1, "cat": 2, "dog": 3, ". . .": 4, "emu": 5,
                  "4.5": 6}
    for index in (None, word_index):
        ref = jl.WordEmbedding(str(path), word_index=index,
                               input_length=4)
        port = tl.WordEmbedding(str(path), word_index=index,
                                input_length=4)
        assert port.word_index == ref.word_index
        assert port.n_pretrained == ref.n_pretrained
        np.testing.assert_array_equal(port.pretrained, ref.pretrained)
        assert tl.WordEmbedding.get_word_index(str(path)) == \
            jl.WordEmbedding.get_word_index(str(path))
        port.ensure_built((4,))
        ids = np.array([[0, 1, 2, 4]], np.int32)
        got, _ = port.call({}, torch.from_numpy(ids),
                           state=port.init_state())
        np.testing.assert_array_equal(got.numpy()[0],
                                      np.asarray(ref.pretrained)[ids[0]])
    assert np.asarray(port.pretrained)[4].tolist() == [0.5, 0.5, 0.5]


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------

RNN_CASES = [(name, seq, back) for name in ("SimpleRNN", "LSTM", "GRU")
             for seq in (False, True) for back in (False, True)]


@pytest.mark.parametrize("name,seq,back", RNN_CASES)
def test_rnn_matches_jax(name, seq, back):
    """SimpleRNN, LSTM and GRU with ``return_sequences`` x
    ``go_backwards`` (a backward layer returning sequences flips them
    back): forward within 2e-5, every parameter's and the input's gradient
    within 1e-4 (B 3, T 6, F 4, units 5)."""
    x = np.random.default_rng(3).normal(size=(3, 6, 4)).astype(np.float32)
    errs = _run(lambda m: getattr(m, name)(5, return_sequences=seq,
                                           go_backwards=back), x)
    assert errs.pop("forward") <= RNN_FWD_TOL
    assert max(errs.values()) <= RNN_GRAD_TOL, errs


def test_rnn_inner_activation_is_hard_sigmoid():
    """The default inner activation is ``jax.nn.hard_sigmoid`` (relu6(x +
    3) / 6), which ``torch.nn.LSTM`` (logistic gates) does not compute:
    at large parameters the gates saturate where the logistic does not."""
    x = np.random.default_rng(4).normal(size=(2, 4, 3)).astype(np.float32)
    errs = _run(lambda m: m.LSTM(4, return_sequences=True), x, scale=2.0)
    assert errs.pop("forward") <= RNN_FWD_TOL
    assert max(errs.values()) <= RNN_GRAD_TOL, errs


@pytest.mark.parametrize("mode", ["concat", "sum", "mul", "ave"])
def test_bidirectional_merge_modes_match_jax(mode):
    """Bidirectional(LSTM) in each merge mode, returning sequences: its
    ``{"fwd", "bwd"}`` tree carried over, forward within 2e-5, gradients
    within 1e-4; the backward half's ``go_backwards`` flipped on a deep
    copy."""
    x = np.random.default_rng(5).normal(size=(2, 5, 3)).astype(np.float32)
    errs = _run(lambda m: m.Bidirectional(m.LSTM(4, return_sequences=True),
                                          merge_mode=mode), x)
    assert errs.pop("forward") <= RNN_FWD_TOL
    assert max(errs.values()) <= RNN_GRAD_TOL, errs
    layer = tl.Bidirectional(tl.GRU(4))
    assert layer.backward_layer.go_backwards \
        and not layer.forward_layer.go_backwards
    layer.ensure_built((5, 3))
    assert set(layer.init_params(torch.Generator().manual_seed(0))) == \
        {"fwd", "bwd"}
    assert layer.compute_output_shape((None, 5, 3)) == (None, 8)


def test_time_distributed_matches_jax():
    """TimeDistributed(Dense) as a stateless layer (``{"inner"}``), and
    TimeDistributed(BatchNormalization) as a stateful one: a training
    forward's output and moving statistics, then an inference forward from
    them, all within 1e-5 of the reference."""
    x = np.random.default_rng(6).normal(size=(2, 5, 3)).astype(np.float32)
    errs = _run(lambda m: m.TimeDistributed(m.Dense(4, activation="tanh")),
                x)
    assert max(errs.values()) <= 1e-5, errs

    jlayer = jl.TimeDistributed(jl.BatchNormalization())
    tlayer = tl.TimeDistributed(tl.BatchNormalization())
    for layer in (jlayer, tlayer):
        layer.ensure_built((5, 3))
    assert tlayer.stateful
    params = _random_like(jlayer.init_params(jax.random.PRNGKey(0)),
                          np.random.default_rng(7), 0.5)
    jstate = jlayer.init_state()
    tstate = params_from_jax(jstate, device="cpu")
    assert _shapes(tstate) == _shapes(jstate)
    tp = params_from_jax(params, device="cpu")
    for training in (True, False):
        want, jstate = jlayer.call(params, jnp.asarray(x), state=jstate,
                                   training=training)
        got, tstate = tlayer.call(tp, torch.from_numpy(x), state=tstate,
                                  training=training)
        assert _err(got.numpy(), want) <= 1e-5
        for path, leaf in _leaves(jstate).items():
            assert _err(_leaves(tstate)[path].numpy(), leaf) <= 1e-5


CONV_LSTM_CASES = {
    "2d_same": ("ConvLSTM2D", (2, 4, 6, 5, 2), {"border_mode": "same"}),
    "2d_valid_stride2": ("ConvLSTM2D", (2, 3, 7, 6, 2),
                         {"border_mode": "valid", "subsample": 2,
                          "return_sequences": True}),
    "2d_same_stride2_backwards": ("ConvLSTM2D", (1, 3, 5, 5, 3),
                                  {"border_mode": "same", "subsample": 2,
                                   "return_sequences": True,
                                   "go_backwards": True}),
    "3d_same": ("ConvLSTM3D", (1, 3, 4, 4, 4, 2), {"border_mode": "same",
                                                   "return_sequences": True}),
    "3d_valid_stride2": ("ConvLSTM3D", (1, 2, 5, 5, 5, 2),
                         {"border_mode": "valid", "subsample": 2}),
}


@pytest.mark.parametrize("case", sorted(CONV_LSTM_CASES))
def test_conv_lstm_matches_jax(case):
    """ConvLSTM2D/3D with same and valid padding and a stride (applied to
    the input convolution only; the recurrent one is SAME at stride 1):
    forward and gradients within 1e-4."""
    name, shape, kwargs = CONV_LSTM_CASES[case]
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    errs = _run(lambda m: getattr(m, name)(3, 3, **kwargs), x, scale=0.3)
    assert max(errs.values()) <= CONV_LSTM_TOL, errs
