"""The port's weight-only int8 matmul against the JAX package's.

The same seeded numpy inputs go through the port's plain version
(``ops/cuda/int8_matmul._reference``, what a CPU tensor takes) and through
the JAX package's ``_reference`` and its Pallas kernel in interpret mode
(``ZOO_KERNEL_INTERPRET=1``, as ``tests/test_kernels.py`` runs it).

Tolerances (relative L2 over the output):
- f32 against JAX's ``_reference``: 1e-5 (both sum K f32 products, in
  another order; measured ~1e-7);
- f32 against the interpret-mode kernel: 1e-5 (it sums over K in blocks of
  256 into a scratch accumulator);
- bf16 x: both round the f32 result to bf16 once, so they agree within one
  bf16 step of the output, 2**-8 relative.

``quantized_matmul`` routing is read from ``kernel_invocation_counts``: a
kernel pick reaches the wrapper (here its plain version, ``plain`` +1), the
dequantize route does not touch it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as tim
from analytics_zoo_tpu_torch.ops.cuda import kernel_invocation_counts
from analytics_zoo_tpu_torch.parallel import (
    compile_step,
    int8_serving,
    with_kernels,
)
from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
    QuantizedTensor,
    quantized_matmul,
)

F32_TOL = 1e-5
BF16_TOL = 2 ** -8

# (M, K, N): ragged on every axis, the BERT-base head, K = 3072 (out)
SHAPES = [(13, 200, 70), (8, 768, 2), (16, 3072, 64)]


def _inputs(m, k, n, seed=0):
    gen = np.random.default_rng(seed)
    x = gen.normal(size=(m, k)).astype(np.float32)
    w = gen.integers(-127, 128, size=(k, n)).astype(np.int8)
    s = gen.uniform(0.005, 0.02, size=(n,)).astype(np.float32)
    return x, w, s


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _port(x, w, s, dtype):
    tx = torch.from_numpy(x).to(dtype)
    return tim.int8_matmul(tx, torch.from_numpy(w), torch.from_numpy(s))


def _as_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_reference_f32(shape):
    from analytics_zoo_tpu.ops.pallas import int8_matmul as jim

    x, w, s = _inputs(*shape)
    got = _port(x, w, s, torch.float32)
    want = jim._reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    assert got.dtype == torch.float32 and got.shape == shape[::2]
    assert _rel(_as_np(got), want) <= F32_TOL


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_reference_bf16(shape):
    from analytics_zoo_tpu.ops.pallas import int8_matmul as jim

    x, w, s = _inputs(*shape, seed=1)
    got = _port(x, w, s, torch.bfloat16)
    want = jim._reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                          jnp.asarray(s))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(_as_np(got), np.asarray(want, np.float32)) <= BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_interpret_kernel(shape, dtype, monkeypatch):
    from analytics_zoo_tpu.ops.pallas import int8_matmul as jim

    x, w, s = _inputs(*shape, seed=2)
    monkeypatch.setenv("ZOO_KERNEL_INTERPRET", "1")
    before = jim.invocation_counts["pallas"]
    want = jim.int8_matmul(jnp.asarray(x, getattr(jnp, dtype)),
                           jnp.asarray(w), jnp.asarray(s))
    assert jim.invocation_counts["pallas"] == before + 1
    got = _port(x, w, s, getattr(torch, dtype))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(_as_np(got), np.asarray(want, np.float32)) <= tol


def _qt(w, s, axis=1):
    return QuantizedTensor(torch.from_numpy(w),
                           torch.from_numpy(s).reshape(
                               (1, -1) if axis == 1 else (-1, 1)), axis)


def _counts():
    return dict(kernel_invocation_counts()["int8_matmul"])


def _routes(x, qt, plan):
    """(output, change in the int8_matmul counts) of quantized_matmul under
    ``plan`` (None: no active plan)."""
    before = _counts()
    fn = (lambda: quantized_matmul(x, qt))
    out = fn() if plan is None else compile_step(fn, plan)()
    after = _counts()
    return out, {k: after[k] - before[k] for k in after}


def test_quantized_matmul_routing():
    x, w, s = _inputs(13, 200, 70, seed=3)
    tx = torch.from_numpy(x)
    qt = _qt(w, s)
    want = tim._reference(tx, qt.values, qt.scale.reshape(-1))
    kernel_plan = with_kernels(int8_serving())
    xla_plan = with_kernels(int8_serving(),
                            (("serving.int8_matmul", "xla"),))
    # no plan and a plan without a kernel table: dequantize-then-matmul
    for plan in (None, int8_serving()):
        out, moved = _routes(tx, qt, plan)
        assert moved == {"kernel": 0, "plain": 0}
        assert _rel(out.numpy(), want.numpy()) <= F32_TOL
    # the kernel pick reaches the wrapper (its plain version on the CPU)
    out, moved = _routes(tx, qt, kernel_plan)
    assert moved == {"kernel": 0, "plain": 1}
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    # an explicit "xla" pick takes the dequantize route
    out, moved = _routes(tx, qt, xla_plan)
    assert moved == {"kernel": 0, "plain": 0}
    assert _rel(out.numpy(), want.numpy()) <= F32_TOL


def test_quantized_matmul_shapes_the_kernel_does_not_take():
    """3-D values and an axis-0 scale take the dequantize route even under
    the kernel pick, as in the reference; a plain tensor is a matmul."""
    from analytics_zoo_tpu.pipeline.inference.quantize import (
        QuantizedTensor as JQT,
        quantized_matmul as jax_qmm,
    )
    from analytics_zoo_tpu.parallel.plan import (
        _active_plan as jax_active,
        int8_serving as jax_int8,
        with_kernels as jax_with_kernels,
    )

    gen = np.random.default_rng(4)
    x = gen.normal(size=(6, 32)).astype(np.float32)
    w3 = gen.integers(-127, 128, size=(2, 32, 16)).astype(np.int8)
    s3 = gen.uniform(0.01, 0.02, size=(1, 1, 16)).astype(np.float32)
    w0 = gen.integers(-127, 128, size=(32, 16)).astype(np.int8)
    s0 = gen.uniform(0.01, 0.02, size=(32, 1)).astype(np.float32)
    plan = with_kernels(int8_serving())
    cases = [(QuantizedTensor(torch.from_numpy(w3), torch.from_numpy(s3), 2),
              JQT(jnp.asarray(w3), jnp.asarray(s3), 2)),
             (QuantizedTensor(torch.from_numpy(w0), torch.from_numpy(s0), 0),
              JQT(jnp.asarray(w0), jnp.asarray(s0), 0))]
    for tq, jq in cases:
        out, moved = _routes(torch.from_numpy(x), tq, plan)
        assert moved == {"kernel": 0, "plain": 0}
        with jax_active(jax_with_kernels(jax_int8())):
            want = jax_qmm(jnp.asarray(x), jq)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    dense = torch.from_numpy(w0.astype(np.float32))
    out, moved = _routes(torch.from_numpy(x), dense, plan)
    assert moved == {"kernel": 0, "plain": 0}
    torch.testing.assert_close(out, torch.from_numpy(x) @ dense)


def test_kernel_route_matches_jax_kernel_route(monkeypatch):
    """Under each package's with_kernels(int8_serving()) the two routes
    agree: the port's plain version and the JAX interpret-mode kernel."""
    from analytics_zoo_tpu.ops.pallas import int8_matmul as jim
    from analytics_zoo_tpu.parallel.plan import (
        _active_plan as jax_active,
        int8_serving as jax_int8,
        with_kernels as jax_with_kernels,
    )
    from analytics_zoo_tpu.pipeline.inference.quantize import (
        QuantizedTensor as JQT,
        quantized_matmul as jax_qmm,
    )

    x, w, s = _inputs(8, 768, 2, seed=5)
    monkeypatch.setenv("ZOO_KERNEL_INTERPRET", "1")
    before = jim.invocation_counts["pallas"]
    with jax_active(jax_with_kernels(jax_int8())):
        want = jax_qmm(jnp.asarray(x), JQT(jnp.asarray(w),
                                           jnp.asarray(s).reshape(1, -1), 1))
    assert jim.invocation_counts["pallas"] == before + 1
    got, moved = _routes(torch.from_numpy(x), _qt(w, s),
                         with_kernels(int8_serving()))
    assert moved == {"kernel": 0, "plain": 1}
    assert _rel(got.numpy(), np.asarray(want)) <= F32_TOL
    assert jax.numpy.asarray(want).dtype == jnp.float32
