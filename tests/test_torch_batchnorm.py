"""The port's BatchNormalization and LayerNormalization against the JAX
package's.

The same numpy parameters and inputs go through both packages:

- BatchNormalization in training: three steps threading the moving
  statistics, each step's output and ``moving_mean``/``moving_var``, and
  the gradients of gamma, beta and the input (``jax.grad``); then the eval
  output from the moving statistics.  f32: 1e-5 of each tensor's largest
  magnitude (both take the biased variance in f32; PyTorch sums it in one
  Welford pass, ``jnp.var`` in two, measured ~1e-7);
- bf16 compute: the same bf16 input and parameters (rounded from the same
  f32 values, so equal bits), the statistics in f32 in both (1e-5
  relative: f32 sums of equal bf16 values), the output in bf16 within 1e-2
  of its largest magnitude (each package rounds the folded scale and
  offset to bf16 and then the products; one bf16 step is 2**-8);
- the state dtypes stay f32 under bf16 compute;
- LayerNormalization, forward and gradients, f32 (1e-5);
- ``recalibrate_batchnorm`` sets every BatchNormalization's moving
  statistics to its input batch's (1e-6 relative: the statistics come back
  through one multiplication by 1 - momentum and one division by it) and
  leaves the layers as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

TOL = 1e-5
BF16_TOL = 1e-2


def _err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _pair(shape, **kwargs):
    jlayer, tlayer = jl.BatchNormalization(**kwargs), \
        tl.BatchNormalization(**kwargs)
    jlayer.ensure_built(shape[1:])
    tlayer.ensure_built(shape[1:])
    return jlayer, tlayer


def _params(ch, rng):
    return {"gamma": (1.0 + 0.3 * rng.normal(size=ch)).astype(np.float32),
            "beta": (0.2 * rng.normal(size=ch)).astype(np.float32)}


@pytest.mark.parametrize("shape", [(8, 5, 5, 4), (6, 7, 3), (16, 6)])
def test_batchnorm_training_steps_and_eval_match_jax(shape):
    jlayer, tlayer = _pair(shape)
    rng = np.random.default_rng(0)
    params = _params(shape[-1], rng)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jlayer.init_state()
    ts = tlayer.init_state()
    for step in range(3):
        x = (2.0 + 1.5 * rng.normal(size=shape)).astype(np.float32)
        cot = rng.normal(size=shape).astype(np.float32)
        jy, js_new = jlayer.call(jp, jnp.asarray(x), state=js,
                                 training=True)
        jg = jax.grad(lambda p, a: jnp.sum(jlayer.call(
            p, a, state=js, training=True)[0] * cot),
            argnums=(0, 1))(jp, jnp.asarray(x))
        tp = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        tx = torch.tensor(x, requires_grad=True)
        ty, ts_new = tlayer.call(tp, tx, state=ts, training=True)
        (ty * torch.from_numpy(cot)).sum().backward()
        assert _err(_np(ty), jy) <= TOL, step
        for k in ("moving_mean", "moving_var"):
            assert ts_new[k].dtype == torch.float32
            assert _err(_np(ts_new[k]), js_new[k]) <= TOL, (step, k)
        for k in ("gamma", "beta"):
            assert _err(tp[k].grad.numpy(), jg[0][k]) <= TOL, (step, k)
        assert _err(tx.grad.numpy(), jg[1]) <= TOL, step
        js, ts = js_new, {k: v.detach() for k, v in ts_new.items()}
    # the moving statistics moved off their initial values
    assert float(ts["moving_var"].max()) > 1.0
    x = rng.normal(size=shape).astype(np.float32)
    jy, js_eval = jlayer.call(jp, jnp.asarray(x), state=js, training=False)
    ty, ts_eval = tlayer.call({k: torch.tensor(v) for k, v in
                               params.items()}, torch.tensor(x), state=ts,
                              training=False)
    assert _err(_np(ty), jy) <= TOL
    assert ts_eval is ts  # evaluation leaves the state as it is


def test_batchnorm_bf16_compute_keeps_f32_statistics():
    shape = (16, 4, 4, 8)
    jlayer, tlayer = _pair(shape)
    rng = np.random.default_rng(1)
    params = _params(shape[-1], rng)
    x = (1.0 + rng.normal(size=shape)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.tensor(x).to(torch.bfloat16)
    assert np.array_equal(_np(tx), _np(jx))  # the same bf16 bits
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = {k: torch.tensor(v).to(torch.bfloat16) for k, v in params.items()}
    js, ts = jlayer.init_state(), tlayer.init_state()
    for _ in range(3):
        jy, js = jlayer.call(jp, jx, state=js, training=True)
        ty, ts = tlayer.call(tp, tx, state=ts, training=True)
        assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
        assert _err(_np(ty), jy) <= BF16_TOL
        for k in ("moving_mean", "moving_var"):
            assert ts[k].dtype == torch.float32
            assert _err(_np(ts[k]), js[k]) <= TOL, k
    jy, _ = jlayer.call(jp, jx, state=js, training=False)
    ty, _ = tlayer.call(tp, tx, state=ts, training=False)
    assert _err(_np(ty), jy) <= BF16_TOL


def test_batchnorm_without_scale_and_center():
    shape = (6, 3, 4)
    jlayer, tlayer = _pair(shape, scale=False, center=False, epsilon=1e-2,
                           momentum=0.9)
    assert jlayer.init_params(jax.random.PRNGKey(0)) == {}
    assert tlayer.init_params(torch.Generator().manual_seed(0)) == {}
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    jy, js = jlayer.call({}, jnp.asarray(x), state=jlayer.init_state(),
                         training=True)
    ty, ts = tlayer.call({}, torch.tensor(x), state=tlayer.init_state(),
                         training=True)
    assert _err(_np(ty), jy) <= TOL
    assert _err(_np(ts["moving_var"]), js["moving_var"]) <= TOL


def test_layernorm_matches_jax():
    shape = (3, 5, 16)
    jlayer, tlayer = jl.LayerNormalization(), tl.LayerNormalization()
    jlayer.ensure_built(shape[1:])
    tlayer.ensure_built(shape[1:])
    rng = np.random.default_rng(3)
    params = _params(shape[-1], rng)
    x = (3.0 + rng.normal(size=shape)).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy = jlayer.call(jp, jnp.asarray(x))
    jg = jax.grad(lambda p, a: jnp.sum(jlayer.call(p, a) * cot),
                  argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = tlayer.call(tp, tx)
    (ty * torch.from_numpy(cot)).sum().backward()
    assert _err(_np(ty), jy) <= TOL
    for k in ("gamma", "beta"):
        assert _err(tp[k].grad.numpy(), jg[0][k]) <= TOL, k
    assert _err(tx.grad.numpy(), jg[1]) <= TOL


def test_recalibrate_batchnorm_sets_the_batch_statistics():
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential

    init_zoo_context(seed=1, device="cpu")
    net = Sequential()
    net.add(tl.BatchNormalization(momentum=0.9, input_shape=(6, 6, 3),
                                  name="bn1"))
    net.add(tl.Convolution2D(4, 3, 3, name="conv"))
    net.add(tl.BatchNormalization(name="bn2"))
    net.add(tl.Flatten())
    net.add(tl.Dense(2))
    net.build_params()
    x = np.random.default_rng(2).normal(1.0, 2.0, (5, 6, 6, 3)).astype(
        np.float32)
    tl.recalibrate_batchnorm(net, x)
    assert [ly.momentum for ly in net.layers
            if isinstance(ly, tl.BatchNormalization)] == [0.9, 0.99]
    h1 = net.layers[0].call(net.params["bn1"], torch.from_numpy(x),
                            state=net.state["bn1"])[0]
    h2 = net.layers[1].call(net.params["conv"], h1)
    for name, h in (("bn1", torch.from_numpy(x)), ("bn2", h2)):
        want = h.double().numpy().reshape(-1, h.shape[-1])
        got = net.state[name]
        assert got["moving_mean"].dtype == torch.float32
        np.testing.assert_allclose(got["moving_mean"].numpy(),
                                   want.mean(0), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["moving_var"].numpy(),
                                   want.var(0), rtol=1e-6)
