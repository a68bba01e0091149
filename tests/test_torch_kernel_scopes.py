"""Kernel scopes under a plan, in the port and in the JAX package.

Each scope the port routes (``attention``, ``loss.softmax_xent``,
``optimizer.adam``) is run with no plan, with the plan's kernel pick and
with an explicit ``"xla"`` pick, and held against the JAX package under the
same plan (its Pallas kernels in interpret mode where it picks them).  The
port's counters show the route: on the CPU a kernel pick reaches the
wrapper, which takes its plain version (``plain`` +1); ``"xla"`` takes the
scope's plain PyTorch path and never reaches the wrapper.  With no plan the
port keeps the routing of its serving and training slices: every scope
goes to its wrapper.

Tolerances: attention 1e-4 absolute (f32, sums in another order); the
loss 1e-6; training losses 1e-5 relative per epoch (the existing training
parity bound: optax and the fused Adam round 1 - b2 differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops.cuda import kernel_invocation_counts
from analytics_zoo_tpu_torch.parallel import plan as tplan

ALL_XLA = ((r"^attention$", "xla"), (r"^optimizer\.adam$", "xla"),
           (r"^loss\.softmax_xent$", "xla"))


@pytest.fixture(autouse=True)
def _restore_contexts():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine

    saved = jax_engine._CONTEXT, torch_engine._CONTEXT
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved


def _plans(kind):
    """(port plan, JAX plan) for a kind: None, "kernels" or "xla"."""
    from analytics_zoo_tpu.parallel import plan as jplan

    if kind is None:
        return None, None
    if kind == "kernels":
        return (tplan.with_kernels(tplan.data_parallel()),
                jplan.with_kernels(jplan.data_parallel()))
    return (tplan.with_kernels(tplan.data_parallel(), ALL_XLA),
            jplan.with_kernels(jplan.data_parallel(), ALL_XLA))


def _under(plan, fn, active):
    if plan is None:
        return fn()
    with active(plan):
        return fn()


def _moved(before, name):
    after = kernel_invocation_counts()[name]
    return {k: after[k] - before[name][k] for k in after}


@pytest.mark.parametrize("kind", [None, "kernels", "xla"])
def test_attention_scope(kind, monkeypatch):
    from analytics_zoo_tpu.ops.attention import (
        dot_product_attention as jax_attention,
    )
    from analytics_zoo_tpu.ops.pallas import flash_attention as jfa
    from analytics_zoo_tpu.parallel.plan import _active_plan as jax_active
    from analytics_zoo_tpu_torch.ops.attention import dot_product_attention

    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    gen = np.random.default_rng(0)
    q, k, v = (gen.normal(size=(1, 2, 256, 64)).astype(np.float32) * 0.5
               for _ in range(3))
    mask = np.zeros((1, 1, 1, 256), np.float32)
    mask[..., 200:] = np.finfo(np.float32).min
    tp, jp = _plans(kind)
    before = kernel_invocation_counts()
    got = _under(tp, lambda: dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v, mask))), tplan._active_plan)
    moved = _moved(before, "flash_attention_fwd")
    pallas = jfa.invocation_counts["pallas"]
    want = _under(jp, lambda: jax_attention(
        *(jnp.asarray(a) for a in (q, k, v, mask))), jax_active)
    took_flash = kind != "xla"
    assert moved == {"kernel": 0, "plain": int(took_flash)}
    assert (jfa.invocation_counts["pallas"] > pallas) == took_flash
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("kind", [None, "kernels", "xla"])
def test_loss_scope(kind, monkeypatch):
    from analytics_zoo_tpu.parallel.plan import _active_plan as jax_active
    from analytics_zoo_tpu.pipeline.api.keras.objectives import (
        sparse_categorical_crossentropy_from_logits as jax_loss,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        sparse_categorical_crossentropy_from_logits,
    )

    monkeypatch.setenv("ZOO_KERNEL_INTERPRET", "1")
    gen = np.random.default_rng(1)
    logits = (gen.normal(size=(8, 5)) * 3).astype(np.float32)
    labels = gen.integers(0, 5, 8).astype(np.int32)
    tp, jp = _plans(kind)
    before = kernel_invocation_counts()
    got = _under(tp, lambda: sparse_categorical_crossentropy_from_logits(
        torch.from_numpy(labels), torch.from_numpy(logits)),
        tplan._active_plan)
    moved = _moved(before, "softmax_xent_fwd")
    want = _under(jp, lambda: jax_loss(jnp.asarray(labels),
                                       jnp.asarray(logits)), jax_active)
    assert moved == {"kernel": 0, "plain": int(kind != "xla")}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _train_data():
    gen = np.random.default_rng(0)
    x = gen.normal(size=(64, 8)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(8, 4))
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


def _mlp(keras, layers):
    m = keras.Sequential()
    m.add(layers.Dense(16, activation="relu", input_shape=(8,)))
    m.add(layers.Dense(4))
    return m


@pytest.mark.parametrize("kind", [None, "kernels", "xla"])
def test_training_scopes(kind, monkeypatch):
    """Two epochs of a Dense classifier under each plan: the epoch
    losses match the JAX package under the same plan, and the port's
    counters show which scopes reached their wrappers."""
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jk
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init
    from analytics_zoo_tpu_torch.convert import params_from_jax
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    import jax

    monkeypatch.setenv("ZOO_KERNEL_INTERPRET", "1")
    loss = "sparse_categorical_crossentropy_from_logits"
    x, y = _train_data()
    tp, jp = _plans(kind)
    jax_init(seed=3)
    jnet = _mlp(jk, jl)
    jnet.build_params()
    jnet.compile(optimizer=JAdam(1e-2), loss=loss)
    torch_init(seed=3, device="cpu")
    tnet = _mlp(tk, tl)
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    tnet.compile(optimizer=Adam(1e-2), loss=loss)
    jnet.fit(x, y, batch_size=16, nb_epoch=2, plan=jp)
    before = kernel_invocation_counts()
    tnet.fit(x, y, batch_size=16, nb_epoch=2, plan=tp)
    steps = 2 * 64 // 16
    kernel = int(kind != "xla")
    # Adam: the 8 x 16 kernel (128 elements) reaches the wrapper; the
    # 16 x 4 kernel and the biases are under its 128-element gate
    assert _moved(before, "fused_adam") == {"kernel": 0,
                                            "plain": steps * kernel}
    assert _moved(before, "softmax_xent_fwd") == {"kernel": 0,
                                                  "plain": steps * kernel}
    assert _moved(before, "softmax_xent_bwd") == {"kernel": 0,
                                                  "plain": steps * kernel}
    assert len(tnet._estimator.loss_log) == steps
    # each epoch's record holds its last step's loss
    np.testing.assert_allclose([h["loss"] for h in tnet._estimator.history],
                               [h["loss"] for h in jnet._estimator.history],
                               rtol=1e-5)
    assert tnet.evaluate(x, y, batch_size=16)["loss"] == pytest.approx(
        jnet.evaluate(x, y, batch_size=16)["loss"], rel=1e-5)


@pytest.mark.parametrize("plan", ["dp+bf16", "dp+int8", "dp+f16+kernels",
                                  "mixed_precision"])
def test_fit_refuses_compute_roles(plan):
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator

    if plan == "mixed_precision":
        plan = tplan.mixed_precision()
    init_zoo_context(seed=3, device="cpu")
    m = _mlp(tk, tl)
    m.build_params()
    m.compile(optimizer="adam",
              loss="sparse_categorical_crossentropy_from_logits")
    x, y = _train_data()
    w0 = m.get_weights()
    with pytest.raises(NotImplementedError, match="queue 1 item 22"):
        m.fit(x, y, batch_size=16, nb_epoch=1, plan=plan)
    with pytest.raises(NotImplementedError, match="queue 1 item 22"):
        Estimator(m, plan=plan)._resolve_plan()
    # nothing trained
    for a, b in zip(*(np.concatenate([np.ravel(v) for d in t.values()
                                      for v in d.values()])
                      for t in (w0, m.get_weights()))):
        assert a == b
