"""The port's fused softmax cross-entropy, losses and metrics against the
JAX package's.

On the CPU the port's ``softmax_xent`` runs the plain forward and backward
of its CUDA kernels (which tests/test_torch_training_kernels.py holds
against them on a GPU).  The reference runs its Pallas kernels in
interpret mode (``ZOO_KERNEL_INTERPRET=1``) and its jnp fallback.  Inputs
come from numpy with a seed.  Tolerance 1e-5: f32 on both sides, the
log-sum-exp summed over the vocab in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.pallas import fused_softmax_xent as jfx
from analytics_zoo_tpu.pipeline.api.keras import metrics as jmetrics
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as tfx
from analytics_zoo_tpu_torch.pipeline.api.keras import metrics as tmetrics
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as tobj

TOL = 1e-5


def _inputs(b, v, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    return x, rng.integers(0, v, b).astype(np.int32), \
        rng.normal(size=b).astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 2), (16, 1000)],
                         ids=["head", "many_blocks"])
def test_forward_backward_match_jax(shape, monkeypatch):
    x, labels, g = _inputs(*shape, seed=shape[1])
    monkeypatch.setenv("ZOO_KERNEL_INTERPRET", "1")
    before = jfx.invocation_counts["pallas"]
    want, vjp = jax.vjp(lambda a: jfx.softmax_xent(a, jnp.asarray(labels)),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    assert jfx.invocation_counts["pallas"] == before + 2  # fwd and bwd
    tx = torch.from_numpy(x).requires_grad_()
    got = tfx.softmax_xent(tx, torch.from_numpy(labels))
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               rtol=TOL, atol=TOL)
    ref_loss, ref_lse = jfx._reference_fwd(jnp.asarray(x),
                                           jnp.asarray(labels))
    loss, lse = tfx.xent_reference(torch.from_numpy(x),
                                   torch.from_numpy(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2 ** -7),
                                       ("float16", 2 ** -10)],
                         ids=["bf16", "f16"])
def test_bf16_logits_give_bf16_gradients(dtype, tol):
    """16-bit logits: the loss in f32, the gradient in the logits' type,
    within one step of it of the reference's (bf16 2**-7, f16 2**-10: both
    round an f32 gradient of magnitude below 2 once); the loss and lse as
    the reference's on the same 16-bit logits."""
    x, labels, g = _inputs(8, 300, seed=1)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss = tfx.softmax_xent(tx, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    assert loss.dtype == torch.float32 \
        and tx.grad.dtype == getattr(torch, dtype)
    jx = jnp.asarray(tx.detach().float().numpy()).astype(getattr(jnp, dtype))
    want_loss, want_lse = jfx._reference_fwd(jx, jnp.asarray(labels))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               rtol=TOL, atol=TOL)
    want = jfx._reference_bwd(jx, jnp.asarray(labels), want_lse,
                              jnp.asarray(g))
    assert want.dtype == getattr(jnp, dtype)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_labels_get_no_gradient_and_shapes_are_checked():
    x, labels, _ = _inputs(4, 10, seed=2)
    tx = torch.from_numpy(x).requires_grad_()
    tfx.softmax_xent(tx, torch.from_numpy(labels)).sum().backward()
    assert tx.grad is not None
    with pytest.raises(ValueError):
        tfx.softmax_xent(tx, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        tfx.softmax_xent(tx[None], torch.from_numpy(labels))


@pytest.mark.parametrize("kind", ["2d", "2d_col_labels", "3d"])
def test_from_logits_loss_routes_like_jax(kind, monkeypatch):
    """(B, V) logits with (B,) labels go to the fused op, in the port as in
    the reference under its kernel plane; 3-D logits take log-softmax."""
    rng = np.random.default_rng(3)
    shape = (6, 5, 11) if kind == "3d" else (6, 11)
    logits = rng.normal(size=shape).astype(np.float32)
    labels = rng.integers(0, 11, shape[:-1]).astype(np.int32)
    if kind == "2d_col_labels":
        labels = labels[:, None]
    calls = []
    real = tobj.softmax_xent
    monkeypatch.setattr(tobj, "softmax_xent",
                        lambda *a: calls.append(1) or real(*a))
    got = tobj.get_loss("sparse_categorical_crossentropy_from_logits")
    out = got(torch.from_numpy(labels), torch.from_numpy(logits))
    want = jobj.sparse_categorical_crossentropy_from_logits(
        jnp.asarray(labels), jnp.asarray(logits))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert calls == ([] if kind == "3d" else [1])
    w = rng.random(6).astype(np.float32)
    jl = jobj.get_loss("sparse_categorical_crossentropy_from_logits")
    assert float(got.mean(torch.from_numpy(labels),
                          torch.from_numpy(logits),
                          torch.from_numpy(w))) == pytest.approx(
        float(jl.mean(jnp.asarray(labels), jnp.asarray(logits),
                      jnp.asarray(w))), rel=TOL)


def test_probability_loss_matches_jax():
    rng = np.random.default_rng(4)
    probs = rng.random((7, 4)).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    labels = rng.integers(0, 4, 7).astype(np.int32)
    got = tobj.sparse_categorical_crossentropy(torch.from_numpy(labels),
                                               torch.from_numpy(probs))
    want = jobj.sparse_categorical_crossentropy(jnp.asarray(labels),
                                                jnp.asarray(probs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    named = tobj.get_loss("sparse_categorical_crossentropy")
    assert tobj.get_loss(named) is named and named.name == \
        "sparse_categorical_crossentropy"
    assert tobj.get_loss("hinge").fn is tobj.hinge
    with pytest.raises(ValueError, match="unknown loss"):
        tobj.get_loss("no_such_loss")


@pytest.mark.parametrize("name", ["accuracy", "acc",
                                  "sparse_categorical_accuracy",
                                  "categorical_accuracy"])
def test_accuracy_matches_jax(name):
    rng = np.random.default_rng(5)
    preds = rng.normal(size=(9, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 9).astype(np.int32)
    mask = (np.arange(9) < 7).astype(np.float32)
    got_m, want_m = tmetrics.get_metric(name), jmetrics.get_metric(name)
    assert got_m.name == want_m.name
    for m in (None, mask):
        got = got_m.batch_stats(torch.from_numpy(labels),
                                torch.from_numpy(preds),
                                None if m is None else torch.from_numpy(m))
        want = want_m.batch_stats(jnp.asarray(labels), jnp.asarray(preds),
                                  None if m is None else jnp.asarray(m))
        assert got_m.finalize(got) == pytest.approx(want_m.finalize(want))
    loss = tmetrics.Loss(tobj.get_loss(
        "sparse_categorical_crossentropy_from_logits"))
    num, den = loss.batch_stats(torch.from_numpy(labels),
                                torch.from_numpy(preds))
    assert float(den) == 9 and np.isfinite(float(num))
    assert isinstance(tmetrics.get_metric("auc"), tmetrics.AUC)
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.get_metric("no_such_metric")
