"""The arithmetic the int8 kernel's f32 route rests on, on the CPU.

``csrc/int8_matmul.cu`` multiplies f32 x on the tensor cores as three bf16
products: x splits into hi = bf16(x), mid = bf16(x - hi) and
lo = bf16(x - hi - mid), each multiplied by the same int8 W into one f32
sum.  That is f32 math only if the three pieces sum to x exactly and each
product is exact, which these tests check through the plain
``split_bf16x3`` (the kernel's split, step for step).  They also check
that the kernel's order of summation, each 64-deep K slice summed apart
and then added into an f32 total, stays within the f32 tolerance at the K
of BERT-base and beyond.  Nothing here imports the JAX package.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as tim

KINDS = ["normal", "tiny", "large", "mixed"]
F32_TOL = 1e-5  # relative L2, the kernel's f32 tolerance
BK = 64         # the kernel's K slice


def _x(kind, shape, seed=0):
    gen = np.random.default_rng(seed)
    if kind == "mixed":  # magnitudes from 2^-60 to 2^60 side by side
        scale = 2.0 ** gen.integers(-60, 61, size=shape)
    else:
        scale = {"normal": 1.0, "tiny": 1e-20, "large": 1e30}[kind]
    return torch.from_numpy((gen.normal(size=shape) * scale).astype(
        np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_split_reproduces_x_exactly(kind):
    x = _x(kind, (64, 257))
    parts = tim.split_bf16x3(x)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    total = sum(p.double() for p in parts)
    assert torch.equal(total, x.double())
    # each piece carries the next 8 bits: |mid| <= 2^-8 |hi|, likewise lo
    hi, mid, lo = (p.double().abs() for p in parts)
    assert (mid <= hi * 2.0 ** -8).all() and (lo <= mid * 2.0 ** -8).all()


@pytest.mark.parametrize("kind", KINDS)
def test_three_products_with_int8_weights_are_the_f32_product(kind):
    x = _x(kind, (16, 768), seed=1)
    gen = np.random.default_rng(2)
    w = torch.from_numpy(gen.integers(-127, 128, size=(768, 96)).astype(
        np.int8)).double()
    want = x.double() @ w
    got = sum(p.double() @ w for p in tim.split_bf16x3(x))
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 2.0 ** -22
    # every product of a piece and a weight is exact in f32: at most 8 + 8
    # significant bits
    for p in tim.split_bf16x3(x):
        prod = p.double()[:, :1] * w[:1, :]
        assert torch.equal(prod.float().double(), prod)


@pytest.mark.parametrize("kind", ["normal", "tiny", "large"])
def test_split_of_a_bf16_value_is_that_value(kind):
    x = _x(kind, (32, 96), seed=3).to(torch.bfloat16).float()
    hi, mid, lo = tim.split_bf16x3(x)
    assert torch.equal(hi.float(), x)
    assert not mid.float().any() and not lo.float().any()


@pytest.mark.parametrize("k", [768, 3072, 4096, 8192])
def test_slice_sums_added_in_f32_meet_the_f32_tolerance(k):
    """The kernel's f32 route with exact tensor-core products: each K
    slice's three products summed (here exactly, in float64) and rounded
    to f32, the slices added one by one into an f32 total."""
    gen = np.random.default_rng(k)
    x = torch.from_numpy(gen.normal(size=(64, k)).astype(np.float32))
    w = torch.from_numpy(gen.integers(-127, 128, size=(k, 48)).astype(
        np.int8)).double()
    pieces = [p.double() for p in tim.split_bf16x3(x)]
    total = torch.zeros(64, 48, dtype=torch.float32)
    for k0 in range(0, k, BK):
        total += sum(p[:, k0:k0 + BK] @ w[k0:k0 + BK]
                     for p in pieces).float()
    want = x.double() @ w
    rel = ((total.double() - want).norm() / want.norm()).item()
    assert rel <= F32_TOL / 10
