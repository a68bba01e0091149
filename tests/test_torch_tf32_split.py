"""The arithmetic the flash-attention backward kernel rests on, on the CPU.

``csrc/flash_attention_bwd.cu`` multiplies f32 operands on the tensor cores
in tf32 (10 mantissa bits) as three products: each operand x splits into
hi = tf32(x), rounded to nearest, and lo = x - hi, and a product is
lo * hi + hi * lo + hi * hi (3xTF32).  That is f32 math only if the two
pieces sum to x exactly and the dropped lo * lo term and the tf32 read of
lo stay near f32's rounding, which these tests check through the plain
``split_tf32``, ``tf32_read`` and ``matmul_3xtf32`` (the kernel's split and
products, step for step).  Nothing here imports the JAX package.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops.cuda import flash_attention as tfa

KINDS = ["normal", "subnormal_adjacent", "large", "mixed"]


def _x(kind, shape, seed=0):
    gen = np.random.default_rng(seed)
    if kind == "subnormal_adjacent":  # around f32's smallest normal 2^-126
        scale = 2.0 ** gen.integers(-130, -122, size=shape)
    elif kind == "mixed":  # magnitudes from 2^-60 to 2^60 side by side
        scale = 2.0 ** gen.integers(-60, 61, size=shape)
    else:  # "large" stays below f32's largest value / (1 + 2^-11)
        scale = {"normal": 1.0, "large": 1e36}[kind]
    return torch.from_numpy((gen.normal(size=shape) * scale).astype(
        np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_split_is_exact_and_hi_is_rounded_tf32(kind):
    x = _x(kind, (64, 257))
    hi, lo = tfa.split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi.double() + lo.double(), x.double())
    # hi has at most 11 significant bits: its low 13 mantissa bits are 0
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    # round to nearest: no tf32 value lies closer to x than hi, and a tie
    # goes away from zero
    bits = x.view(torch.int32)
    down = (bits & ~0x1FFF).view(torch.float32).double()
    up = ((bits & ~0x1FFF) + 0x2000).view(torch.float32).double()
    xd = x.double()
    nearest = torch.where((xd - down).abs() < (up - xd).abs(), down, up)
    assert torch.equal(hi.double(), nearest)
    # lo is at most half a tf32 step (2^-11 of x where x is normal)
    assert (lo.double().abs() <= (up - down).abs() / 2).all()


def test_split_ties_round_away_from_zero():
    # 1 + 2^-11 and its negative lie halfway between two tf32 values
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11],
                     dtype=torch.float32)
    hi, lo = tfa.split_tf32(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                           1 + 2 * 2.0 ** -10]
    assert torch.equal(hi + lo, x)


def test_tf32_read_keeps_the_top_19_bits():
    x = _x("normal", (1000,), seed=3)
    r = tfa.tf32_read(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert ((x.double() - r.double()).abs()
            < x.double().abs() * 2.0 ** -10).all()
    hi, _ = tfa.split_tf32(x)
    assert torch.equal(tfa.tf32_read(hi), hi)


@pytest.mark.parametrize("kind", ["normal", "mixed"])
@pytest.mark.parametrize("depth", [64, 512])
def test_3xtf32_product_is_f32_math(depth, kind):
    """Within 1e-6 of the f64 product, relative to the sum of the terms'
    magnitudes, over the kernel's contractions: 64 (head dim, S and dP)
    and 512 (the sequence, dq, dk and dv)."""
    a = _x(kind, (32, depth), seed=1)
    b = _x("normal", (depth, 48), seed=2)
    want = a.double() @ b.double()
    size = a.double().abs() @ b.double().abs()
    got = tfa.matmul_3xtf32(a, b)
    assert ((got - want).abs() / size).max().item() <= 1e-6
    # a single tf32 product is not: ~2^-11 relative
    one = tfa.tf32_read(a).double() @ tfa.tf32_read(b).double()
    assert ((one - want).abs() / size).max().item() > 1e-5
