"""The port's single-device mixture of experts and remat against the JAX
package: the twins of ``tests/test_moe_layer.py``'s single-device cases.

- ``routed_ffn`` with full dispatch is the dense mixture (within 2e-5) and
  the JAX package's op (within 1e-6); skewed routing drops exactly the
  over-capacity fraction and flags the collapse in the aux loss; tied
  probabilities choose the experts ``lax.top_k`` chooses (the lower
  index first), held by the outputs against the JAX package's (1e-6).
- In ``TransformerLayer``: dropped tokens pass through the residual, the
  state has the reference's three scalars, ``param_count`` is the tree's.
- One ``fit`` step of both packages (the same weights, one batch of 8):
  the training loss is the task loss plus ``moe_aux_cost`` (both within
  1e-5 of the reference), ``evaluate``'s is the task loss alone.
- remat ``"full"``, ``"dots"`` and ``"attn"`` with dropout give the
  port's own ``None`` gradients bit for bit (one thread; on the dense
  attention route, whose masks come from ``torch.rand``, and on the flash
  route, whose masks come from the kernel's hash), and without dropout
  the JAX package's remat gradients within 1e-4 of each leaf's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.moe import routed_ffn as jax_routed_ffn
from analytics_zoo_tpu_torch.common.engine import make_generator
from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.ops.moe import collect_aux_cost, routed_ffn

NAMES = ("gate_w", "w1", "b1", "w2", "b2")


@pytest.fixture(autouse=True)
def _restore():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine

    saved = (jax_engine._CONTEXT, torch_engine._CONTEXT,
             torch.get_num_threads())
    torch.set_num_threads(1)
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved[:2]
    torch.set_num_threads(saved[2])


def _moe_params(seed, d, e, m, gate_bias_to=None, gate_bias=10.0):
    rng = np.random.default_rng(seed)
    gate = 0.1 * rng.normal(size=(d, e))
    if gate_bias_to is not None:
        gate[:, gate_bias_to] += gate_bias
    p = dict(gate_w=gate, w1=0.1 * rng.normal(size=(e, d, m)),
             b1=0.1 * rng.normal(size=(e, m)),
             w2=0.1 * rng.normal(size=(e, m, d)),
             b2=0.1 * rng.normal(size=(d,)))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p, x, **kw):
    """(port's (y, aux, drop) as numpy, the JAX package's)."""
    got = routed_ffn(torch.from_numpy(x),
                     *[torch.from_numpy(p[n]) for n in NAMES], **kw)
    want = jax_routed_ffn(jnp.asarray(x), *[jnp.asarray(p[n]) for n in NAMES],
                          **kw)
    return ([np.asarray(t) for t in got], [np.asarray(t) for t in want])


def test_full_dispatch_matches_dense_mixture():
    """top_k = E with capacity >= S is the dense mixture sum_e p_e MLP_e(x)
    + b2 (within 2e-5), and the JAX package's op (within 1e-6)."""
    d, e, m, b, s = 8, 4, 16, 2, 12
    p = _moe_params(0, d, e, m)
    x = np.random.default_rng(1).normal(size=(b, s, d)).astype(np.float32)
    (y, aux, drop), (jy, jaux, jdrop) = _both(p, x, top_k=e,
                                              capacity_factor=float(e))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    probs = torch.softmax(xt @ t["gate_w"], dim=-1)
    h1 = torch.nn.functional.gelu(
        torch.einsum("bsd,edf->bsef", xt, t["w1"]) + t["b1"][None, None],
        approximate="tanh")
    dense = torch.einsum("bsef,efd->bsed", h1, t["w2"])
    ref = torch.einsum("bsed,bse->bsd", dense, probs) + t["b2"]
    np.testing.assert_allclose(y, ref.numpy(), rtol=2e-5, atol=2e-5)
    assert float(drop) == 0.0 == float(jdrop)
    np.testing.assert_allclose(y, jy, rtol=1e-6, atol=1e-6)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


def test_skewed_routing_exact_drop_fraction_and_aux():
    """Every token wants expert 0: each row keeps its first C tokens, the
    drop fraction is exactly 1 - C/S, the aux loss flags the collapse, and
    the dropped tokens' rows are exactly zero, as in the reference."""
    d, e, m, b, s = 8, 4, 16, 2, 64
    p = _moe_params(0, d, e, m, gate_bias_to=0)
    x = np.random.default_rng(1).uniform(0.5, 1.5, (b, s, d)) \
        .astype(np.float32)
    cap = 16  # ceil(1.0 * 1 * 64 / 4)
    (y, aux, drop), (jy, jaux, jdrop) = _both(p, x, top_k=1,
                                              capacity_factor=1.0)
    assert float(drop) == pytest.approx(1.0 - cap / s, abs=1e-6)
    assert float(drop) == float(jdrop)
    assert float(aux) > 0.9 * e
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    norms = np.linalg.norm(y, axis=-1)
    assert (norms[:, :cap] > 1e-6).all()
    assert (y[:, cap:] == 0.0).all()
    np.testing.assert_allclose(y, jy, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_tied_probabilities_choose_lax_top_k(k):
    """Equal probabilities (a zero router, and a router whose columns come
    in equal pairs) route to the experts ``lax.top_k`` picks, lower index
    first: the same outputs, drop fraction and aux as the JAX package."""
    d, e, m, b, s = 8, 4, 8, 2, 10
    x = np.random.default_rng(2).normal(size=(b, s, d)).astype(np.float32)
    for gate in (np.zeros((d, e), np.float32),
                 np.repeat(_moe_params(3, d, 2, m)["gate_w"], 2, axis=1)):
        p = dict(_moe_params(4, d, e, m), gate_w=gate)
        (y, aux, drop), (jy, jaux, jdrop) = _both(p, x, top_k=k,
                                                  capacity_factor=0.8)
        np.testing.assert_allclose(y, jy, rtol=1e-6, atol=1e-6)
        assert float(drop) == float(jdrop)
        assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    probs = torch.full((3, e), 0.25)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(
        ranked.indices[:, :k].numpy(),
        np.asarray(jax.lax.top_k(jnp.full((3, e), 0.25), k)[1]))


def _layers(**kw):
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        TransformerLayer as J,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        TransformerLayer as T,
    )

    cfg = dict(vocab=32, seq_len=16, n_block=2, n_head=2, hidden_size=16,
               moe_experts=4, moe_top_k=1, moe_capacity_factor=1.0,
               hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0)
    cfg.update(kw)
    return J(**cfg), T(**cfg)


def _jax_params(layer, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  layer.init_params(jax.random.PRNGKey(seed)))


def test_dropped_tokens_survive_via_residual():
    """A zero router ties every expert, so top-1 sends every token to
    expert 0 and 75% are dropped: every output row keeps a healthy norm,
    and the output is the reference's within 1e-5."""
    jlayer, tlayer = _layers()
    params = _jax_params(jlayer)
    for bp in params["blocks"]:
        bp["moe_gate"] = np.zeros_like(bp["moe_gate"])
    tok = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    out, st = tlayer.call(params_from_jax(params, device="cpu"),
                          torch.from_numpy(tok))
    jout, jst = jax.jit(jlayer.call)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tok))
    assert float(st["moe_drop_fraction"]) == pytest.approx(0.75, abs=1e-6)
    assert (np.linalg.norm(out.numpy(), axis=-1) > 1e-3).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for key in st:
        assert float(st[key]) == pytest.approx(float(jst[key]), rel=1e-5)


def test_state_structure_and_param_count():
    """The stateful layer's init state and call state are the reference's
    three 0-d f32 scalars, the aux cost the weighted aux loss; the
    parameter tree has the reference's MoE leaves and shapes, and
    ``param_count`` counts it."""
    jlayer, tlayer = _layers()
    assert tlayer.stateful
    init = tlayer.init_state()
    jinit = jlayer.init_state()
    assert sorted(init) == sorted(jinit)
    assert all(v.shape == () and v.dtype == torch.float32
               for v in init.values())
    tparams = tlayer.init_params(make_generator(0))
    jparams = _jax_params(jlayer)
    shapes = [{k: tuple(v.shape) for k, v in b.items()}
              for b in tparams["blocks"]]
    assert shapes == [{k: tuple(v.shape) for k, v in b.items()}
                      for b in jparams["blocks"]]
    assert {"moe_gate", "moe_w1", "moe_b1", "moe_w2", "moe_b2"} <= \
        set(shapes[0])
    n = sum(t.numel() for b in tparams["blocks"] for t in b.values()) \
        + tparams["tok_embed"].numel() + tparams["pos_embed"].numel()
    assert n == tlayer.param_count() == jlayer.param_count()
    _, st = tlayer.call(tparams, torch.zeros((2, 16), dtype=torch.int32),
                        training=True, rng=make_generator(1))
    assert sorted(st) == sorted(init)
    assert float(st["moe_aux_cost"]) == pytest.approx(
        0.01 * float(st["moe_aux_loss"]), rel=1e-6)
    assert float(collect_aux_cost({"a": st, "b": {"c": 1}})) == \
        float(st["moe_aux_cost"])


def _classifier(keras, layers):
    m = keras.Sequential()
    m.add(layers.TransformerLayer(
        vocab=32, seq_len=16, n_block=2, n_head=2, hidden_size=16,
        moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0,
        hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0,
        input_shape=(16,)))
    m.add(layers.GlobalAveragePooling1D())
    m.add(layers.Dense(2, activation="softmax"))
    return m


def test_fit_step_includes_aux_and_evaluate_excludes_it(tmp_path):
    """One Adam step of both packages from the same weights on one batch
    of 8 (the JAX package's CPU mesh has 8 devices): the logged training
    loss is the task loss plus the state's ``moe_aux_cost`` in both (the
    port's within 1e-5 of the reference's), and ``evaluate``'s loss is the
    task loss alone."""
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jk
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        get_loss,
    )

    jax_init(seed=11)
    torch_init(seed=11, device="cpu")
    jnet, tnet = _classifier(jk, jl), _classifier(tk, tl)
    jnet.build_params()
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 32, size=(8, 16)).astype(np.int32)
    y = rng.integers(0, 2, size=(8,)).astype(np.int32)
    loss = "sparse_categorical_crossentropy"
    for net in (jnet, tnet):
        net.compile(optimizer="adam", loss=loss, metrics=["accuracy"])
    jnet.set_tensorboard(str(tmp_path), "moe")

    preds, st = tnet.forward(tnet.params, torch.from_numpy(x),
                             state=tnet.state, training=True,
                             rng=make_generator(0))
    task = float(get_loss(loss).mean(torch.from_numpy(y), preds))
    aux = [v["moe_aux_cost"] for v in st.values() if "moe_aux_cost" in v]
    assert len(aux) == 1 and float(aux[0]) > 0.0

    jnet.fit(x, y, batch_size=8, nb_epoch=1)
    tnet.fit(x, y, batch_size=8, nb_epoch=1)
    (jstep,) = [v for _, v, _ in
                jnet._estimator._writers[0].read_scalar("Loss")]
    ((_, tstep),) = tnet._estimator.loss_log
    assert tstep == pytest.approx(task + float(aux[0]), rel=1e-6)
    assert tstep == pytest.approx(jstep, rel=1e-5)

    got = tnet.evaluate(x, y, batch_size=8)
    want = jnet.evaluate(x, y, batch_size=8)
    preds, _ = tnet.forward(tnet.params, torch.from_numpy(x),
                            state=tnet.state)
    assert got["loss"] == pytest.approx(
        float(get_loss(loss).mean(torch.from_numpy(y), preds)), rel=1e-6)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def _cotangent(shape):
    return np.random.default_rng(9).normal(size=shape).astype(np.float32)


def _grads(layer, params, tok, rng):
    """[loss, every leaf's gradient] of ``mean(out * w) + moe_aux_cost``
    for a seeded ``w``."""
    leaves = []

    def req(t):
        t = t.clone().requires_grad_()
        leaves.append(t)
        return t

    p = tree_map(req, params)
    out, st = layer.call(p, tok, training=True, rng=rng)
    w = torch.from_numpy(_cotangent(tuple(out.shape)))
    loss = (out * w).mean() + st["moe_aux_cost"]
    return [loss.detach()] + list(torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("policy", ["full", "dots", "attn"])
@pytest.mark.parametrize("route", ["dense", "flash"])
def test_remat_with_dropout_is_bit_for_bit(policy, route):
    """Each remat policy with hidden, embedding and attention dropout 0.1
    gives the loss and every gradient of ``remat=None`` bit for bit: the
    recompute redraws the forward's masks (on the flash route, sequence
    256 at head dim 64, the kernel's hash of the same seed pair)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        TransformerLayer,
    )

    seq, hidden = (16, 16) if route == "dense" else (256, 128)
    cfg = dict(vocab=32, seq_len=seq, n_block=2, n_head=2,
               hidden_size=hidden, moe_experts=4, moe_top_k=2,
               hidden_drop=0.1, attn_drop=0.1, embedding_drop=0.1)
    base = TransformerLayer(**cfg)
    params = base.init_params(make_generator(0))
    tok = torch.arange(seq).remainder(32)[None].repeat(2, 1)
    want = _grads(base, params, tok, make_generator(5))
    got = _grads(TransformerLayer(remat=policy, **cfg), params, tok,
                 make_generator(5))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("policy", ["full", "dots", "attn"])
def test_remat_gradients_match_jax(policy):
    """Without dropout, each policy's gradients within 1e-4 of each
    leaf's largest of the JAX package's, under the same policy."""
    jlayer, tlayer = _layers(remat=policy, moe_top_k=2)
    params = _jax_params(jlayer, seed=3)
    tok = np.tile(np.arange(16, dtype=np.int32), (2, 1))

    def jloss(p):
        out, st = jlayer.call(p, jnp.asarray(tok), training=True,
                              rng=jax.random.PRNGKey(1))
        return jnp.mean(out * _cotangent(out.shape)) + st["moe_aux_cost"]

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jval, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    got = _grads(tlayer, params_from_jax(params, device="cpu"),
                 torch.from_numpy(tok), make_generator(1))
    assert float(got[0]) == pytest.approx(float(jval), rel=1e-5)
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jg))
    # the port's tree in the JAX package's (sorted-key) leaf order
    it = iter(got[1:])
    tgrads = tree_map(lambda t: next(it),
                      params_from_jax(params, device="cpu"))
    ordered = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), tgrads,
                               is_leaf=torch.is_tensor))
    for a, b in zip(ordered, want, strict=True):
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-30)


def test_unknown_remat_policy_raises_the_references_error():
    from analytics_zoo_tpu.parallel.plan import apply_remat as jax_apply
    from analytics_zoo_tpu_torch.parallel.plan import apply_remat

    with pytest.raises(ValueError, match="unknown remat policy 'offload'"):
        jax_apply(lambda x: x, "offload")
    with pytest.raises(ValueError, match="unknown remat policy 'offload'"):
        apply_remat(lambda x: x, "offload")
    fn = lambda x: x  # noqa: E731
    assert apply_remat(fn, None) is fn
