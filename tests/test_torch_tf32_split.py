"""The arithmetic the flash-attention backward kernel rests on, on the CPU.

``csrc/flash_attention_bwd.cu`` multiplies f32 operands on the tensor cores
in tf32 (10 mantissa bits) as three products: each operand x splits into
hi = tf32(x), rounded to nearest, and lo = x - hi, and a product is
lo * hi + hi * lo + hi * hi (3xTF32).  That is f32 math only if the two
pieces sum to x exactly and the dropped lo * lo term and the tf32 read of
lo stay near f32's rounding, which these tests check through the plain
``split_tf32``, ``tf32_read`` and ``matmul_3xtf32`` (the kernel's split and
products, step for step).  The last test models the order in which the
chunked body (head dims above 128) sums its products, and holds that
order against the plain backward.  Nothing here imports the JAX package.
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


# The chunked backward body (``bwd_wide_kernel`` in
# csrc/flash_attention_bwd.cu) contracts S and dP over 32-column chunks.


def _warpgroups(d):
    """Warpgroups a block: 3 where d has a multiple of 3 groups of 64
    columns, else 2; each owns one group of a block's output slice."""
    return 3 if d // 64 % 3 == 0 else 2


def _chunked_scores(a, b, nwg):
    """``a @ b^T`` over the head dim as the chunked body forms S and dP from
    the ``split_tf32`` pieces: with 3 warpgroups, warpgroup w sums product w
    of (lo . hi, hi . lo, hi . hi) over every 32-column chunk; with 2,
    warpgroup w sums the k-steps w and w + 2 of each chunk, lo products
    first; each chunk's products are added into the warpgroup's f32 sum,
    and the warpgroups' sums are added in order."""
    a_hi, a_lo = (tfa.tf32_read(t).double() for t in tfa.split_tf32(a))
    b_hi, b_lo = (tfa.tf32_read(t).double().transpose(-1, -2)
                  for t in tfa.split_tf32(b))
    pieces = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    total = None
    for w in range(nwg):
        acc = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
        for c0 in range(0, a.shape[-1], 32):
            if nwg == 3:
                cols, parts = torch.arange(c0, c0 + 32), [pieces[w]]
            else:
                cols = torch.tensor([c0 + 8 * kk + i for kk in (w, w + 2)
                                     for i in range(8)])
                parts = pieces
            for x, y in parts:
                acc = (acc.double() + x[..., cols] @ y[..., cols, :]).float()
        total = acc if total is None else total + acc
    return total


def _out_product(p, x):
    """``p @ x`` over one 32-row streamed tile as the output products form
    it (3xTF32, lo products first), in a fresh accumulator."""
    return tfa.matmul_3xtf32(p, x).float()


def _chunked_side(own0, own1, str0, str1, m, inv_l, dsum, bias, keep, live,
                  scale, kv):
    """One kernel of the chunked body on whole tensors: S and dP of the own
    rows against every streamed row, the softmax recompute, then per
    32-row streamed tile and per output slice (64 columns a warpgroup) a
    fresh product added into the f32 totals.  Returns (out0, out1, dbias
    partial); the (own, streamed) operands are (q, k) in the dq kernel,
    (k, q) in the dk/dv kernel, whose m, 1 / l, D, bias, keep and live
    come transposed."""
    d = own0.shape[-1]
    nwg = _warpgroups(d)
    s = _chunked_scores(own0, str0, nwg)
    dp = _chunked_scores(own1, str1, nwg)
    p = torch.exp2((s * scale + bias - m) * 1.4426950408889634) * inv_l
    p = torch.where(live, p, 0.0)
    pt = p * keep
    ds = torch.where(live, p * (keep * dp - dsum), 0.0)
    out0 = torch.zeros(own0.shape)
    out1 = torch.zeros(own0.shape)
    db = torch.zeros(own0.shape[:-1])
    for s0 in range(0, str0.shape[-2], 32):
        tile = slice(s0, s0 + 32)
        db = db + ds[..., tile].sum(-1)
        for c0 in range(0, d, 64 * nwg):
            cols = slice(c0, min(c0 + 64 * nwg, d))
            out0[..., cols] += _out_product(ds[..., tile],
                                            str0[..., tile, cols])
            if kv:
                out1[..., cols] += _out_product(pt[..., tile],
                                                str1[..., tile, cols])
    return out0, out1, db


@pytest.mark.parametrize("d", [192, 320])
def test_chunked_backward_order_within_1e5_of_largest_gradient(d):
    """dq, dk, dv and the bias gradient summed in the chunked body's order
    (S and dP over 32-column chunks of tf32 hi and lo pieces, split across
    the warpgroups by product at d 192 and by k-step at d 320,
    a fresh accumulator per 32-row streamed tile, outputs per column slice)
    stay within 1e-5 of each output's largest gradient of the plain
    backward: causal with lq < lk, segment ids, the padding bias and
    dropout 0.1."""
    gen = np.random.default_rng(d)
    b, h, lq, lk, p_drop = 2, 2, 80, 100, 0.1
    q, k, v, g = (torch.from_numpy(gen.normal(size=(b, h, n, d)).astype(
        np.float32)) for n in (lq, lk, lk, lq))
    keep_k = np.arange(lk)[None, :] < gen.integers(lk // 2, lk + 1, b)[:, None]
    bias = torch.from_numpy(np.where(keep_k, 0.0, np.finfo(np.float32).min)
                            .astype(np.float32)[:, None, None, :])
    q_seg, kv_seg = (torch.from_numpy(np.searchsorted(
        np.sort(gen.choice(np.arange(1, n), 2, replace=False)),
        np.arange(n), side="right")[None].repeat(b, 0).astype(np.int32))
        for n in (lq, lk))
    seed, scale = (0x1234ABCD, 0x9E3779B9), 1.0 / np.sqrt(d)
    out, m, l = tfa.attention_reference(q, k, v, True, scale, bias, p_drop,
                                        seed, True, q_seg, kv_seg)
    want = tfa.attention_bwd_reference(q, k, v, g, out, m, l, True, scale,
                                       bias, p_drop, seed, True, q_seg,
                                       kv_seg)
    live = tfa._live(lq, lk, True, q_seg, kv_seg, q.device).expand(
        b, h, lq, lk)
    keep = tfa._keep_scale(seed, p_drop, b, h, lq, 0, lk, q.device)
    full_bias = bias.expand(b, h, lq, lk)
    inv_l = 1.0 / l.clamp_min(1e-20)
    dsum = (g * out).sum(-1)
    dq, _, _ = _chunked_side(q, g, k, v, m[..., None], inv_l[..., None],
                             dsum[..., None], full_bias, keep, live, scale,
                             kv=False)

    def tr(x):
        return x.transpose(-1, -2)

    dk, dv, db = _chunked_side(k, v, q, g, m[..., None, :],
                               inv_l[..., None, :], dsum[..., None, :],
                               tr(full_bias), tr(keep), tr(live), scale,
                               kv=True)
    got = (dq * scale, dk * scale, dv, db.sum(1)[:, None, None, :])
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        err = (x - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item(), (name, err)
