"""The port's engine pieces and layers against the JAX package's.

Inputs and weights come from numpy with a seed and go to both packages
(weights through ``params_from_jax``).  f32 tolerance 1e-5 for the
elementwise pieces and 1e-4 for stacks, as in test_torch_bert_serving.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import params_from_jax


@pytest.fixture(autouse=True)
def _restore_contexts():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine

    saved = jax_engine._CONTEXT, torch_engine._CONTEXT
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("name", [
    "relu", "relu6", "tanh", "sigmoid", "hard_sigmoid", "softmax",
    "log_softmax", "softplus", "softsign", "elu", "selu", "gelu", "swish",
    "silu", "linear", None])
def test_activations_match_jax(name):
    from analytics_zoo_tpu.ops.activations import get_activation as jget
    from analytics_zoo_tpu_torch.ops.activations import get_activation

    x = _np((4, 33), 0, 4.0)
    got = get_activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jget(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spec", [None, "bf16", "bfloat16", "f32", "fp16",
                                  "float32", "none"])
def test_compute_dtype_and_cast_floats_match_jax(spec):
    from analytics_zoo_tpu.common.engine import (
        _resolve_compute_dtype as jresolve,
        cast_floats as jcast,
    )
    from analytics_zoo_tpu_torch.common.engine import (
        _resolve_compute_dtype,
        cast_floats,
    )

    got, want = _resolve_compute_dtype(spec), jresolve(spec, "gpu")
    assert (got is None) == (want is None)
    if got is not None:
        assert str(got).split(".")[-1] == jnp.dtype(want).name
    tree = {"w": np.ones((2, 3), np.float32),
            "ids": np.arange(3, dtype=np.int32)}
    tt = cast_floats({k: torch.from_numpy(v) for k, v in tree.items()}, got)
    jt = jcast({k: jnp.asarray(v) for k, v in tree.items()}, want)
    for k in tree:
        assert str(tt[k].dtype).split(".")[-1] == jnp.dtype(jt[k].dtype).name


@pytest.mark.parametrize("seq", [256, 128], ids=["flash", "dense"])
def test_transformer_layer_matches_jax(seq, monkeypatch):
    """GPT-style causal stack: at 256 both packages route attention to
    flash (the reference's Pallas kernel in interpret mode), at 128 to the
    dense path."""
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        TransformerLayer as JTL,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        TransformerLayer,
    )

    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    kw = dict(vocab=50, seq_len=seq, n_block=2, n_head=2, hidden_size=128,
              intermediate_size=256)
    jl, tl = JTL(**kw), TransformerLayer(**kw)
    jp = jl.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(1).integers(0, 50, (2, seq))
    pos = np.tile(np.arange(seq), (2, 1))
    got = tl.call(tp, [torch.from_numpy(tokens), torch.from_numpy(pos)])
    want = jl.call(jp, [jnp.asarray(tokens), jnp.asarray(pos)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert tl.param_count() == jl.param_count()


def test_sequential_dense_dropout_serves_like_jax():
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSeq
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        Dense as JDense,
        Dropout as JDrop,
    )
    from analytics_zoo_tpu.pipeline.inference.inference_model import (
        InferenceModel as JIM,
    )
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense,
        Dropout,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    def build(seq, dense, drop):
        m = seq()
        m.add(dense(16, activation="relu", input_shape=(12,)))
        m.add(drop(0.5))
        m.add(dense(3, activation="softmax"))
        return m

    jax_init(seed=5)
    init_zoo_context(seed=5, device="cpu")
    jm, tm = build(JSeq, JDense, JDrop), build(Sequential, Dense, Dropout)
    jm.build_params()
    tm.build_params()
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    # the port's own glorot init has the reference's shapes and range
    for name in ("dense_0", "dense_1"):
        k = tm.params[name]["kernel"]
        assert k.shape == jm.params[name]["kernel"].shape
        fan = k.shape[0] + k.shape[1]
        assert k.abs().max().item() <= np.sqrt(6.0 / fan)
    tm.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu"))
    x = _np((5, 12), 2)
    got = InferenceModel().from_keras_net(tm).predict(x, batch_size=2)
    want = JIM().from_keras_net(jm).predict(x, batch_size=2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_unported_training_features_raise():
    from analytics_zoo_tpu_torch.ops.cuda.flash_attention import (
        flash_attention,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        BERT,
        Dropout,
    )

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BERT(vocab=10, hidden_size=64, n_block=1, n_head=1, seq_len=8,
             moe_experts=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BERT(vocab=10, hidden_size=64, n_block=1, n_head=1, seq_len=8,
             remat=True)
    q = torch.zeros(1, 1, 256, 64)
    seg = torch.zeros(1, 256, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(q, q, q, q_segment_ids=seg, kv_segment_ids=seg)
    # training-mode Dropout is ported (test_dropout_trains_like_jax); at
    # inference it is the identity
    assert torch.equal(Dropout(0.5).call({}, torch.ones(2, 2)),
                       torch.ones(2, 2))


def test_dropout_trains_like_jax():
    """Training-mode Dropout keeps ~1-p of the values, scaled by 1/(1-p),
    as the reference's does; the masks come from different generators
    (torch vs jax.random), so the test compares the rule, not the bits."""
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dropout as JDrop
    from analytics_zoo_tpu_torch.common.engine import make_generator
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dropout

    x = np.full((200, 100), 3.0, np.float32)
    got = Dropout(0.25).call({}, torch.from_numpy(x), training=True,
                             rng=make_generator(1)).numpy()
    want = np.asarray(JDrop(0.25).call({}, jnp.asarray(x), training=True,
                                       rng=jax.random.PRNGKey(1)))
    for out in (got, want):
        assert set(np.unique(out)) <= {0.0, np.float32(4.0)}
        assert abs((out == 0).mean() - 0.25) < 0.02
    again = Dropout(0.25).call({}, torch.from_numpy(x), training=True,
                               rng=make_generator(1)).numpy()
    np.testing.assert_array_equal(got, again)  # the generator decides
