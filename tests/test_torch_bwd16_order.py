"""The 16-bit flash-attention backward's arithmetic, on the CPU.

``csrc/flash_attention_bwd.cu`` runs bf16 and f16 inputs at head dims 64
and 128 on the 16-bit tensor cores (``bwd16_kernel``): P t and dS are
rounded to the input type as the register A operands of the output
products, each streamed tile's products go into f32 sums, and in f16 each
own row's dS is first lifted by a power of two, so that rows whose dS lie
below f16's normal range keep their bits.  ``attention_bwd16_model`` (in
``ops/cuda/flash_attention.py``) repeats that order in plain PyTorch; these
tests hold it against the plain backward (f32 math on the same 16-bit
inputs) and against the JAX package's backward (``jax.vjp`` through the
Pallas kernel in interpret mode), with errors relative to each output's
largest gradient, and show what the f16 lift prevents.  The kernel itself
is held to the same bounds on the card (``tests/test_torch_training_
kernels.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from analytics_zoo_tpu_torch.ops.cuda import flash_attention as tfa

# Error of dq, dk and dv relative to each output's largest gradient: four
# units of roundoff of the input type (bf16 2^-8, f16 2^-11).  The outputs'
# own rounding takes up to one; P t and dS, rounded as the products' A
# operands, add their errors over 256-512 terms.  Measured here 2.0e-3 to
# 5.5e-3 (bf16) and 2.2e-4 to 5.6e-4 (f16); the kernel at the BERT-base
# training shape 7.8e-3 and 5.5e-4 (tools/training_kernels_bench.py).
TOP_TOL = {torch.bfloat16: 4 * 2.0 ** -8, torch.float16: 4 * 2.0 ** -11}
# the bias gradient sums dS in f32 before any rounding: f32 sums in another
# order
DBIAS_TOL = 1e-5
FINFO_MIN = float(np.finfo(np.float32).min)
SEED = (0x1234ABCD, 0x9E3779B9)

# (b, h, lq, lk, d, causal, segment ids, dropout): B2 H2, the padding bias
# with a fully masked last record in every case
CASES = [
    (2, 2, 256, 256, 64, False, False, 0.1),
    (2, 2, 300, 256, 64, True, True, 0.1),   # lq > lk, end-aligned
    (2, 2, 256, 300, 128, True, False, 0.0),  # lq < lk
    (2, 2, 300, 300, 128, False, True, 0.1),
]


def _inputs(case, dtype, g_scale=1.0, seed=0):
    b, h, lq, lk, d, causal, segments, p = case
    gen = np.random.default_rng(seed)

    def t(n, scale=1.0):
        return torch.from_numpy((gen.normal(size=(b, h, n, d)) * scale)
                                .astype(np.float32)).to(dtype)

    q, k, v, g = t(lq), t(lk), t(lk), t(lq, g_scale)
    lengths = gen.integers(lk // 4, lk + 1, b)
    keep = (np.arange(lk)[None, :] < lengths[:, None]).astype(np.float32)
    keep[-1] = 0.0
    bias = torch.from_numpy(((1.0 - keep) * FINFO_MIN)[:, None, None, :])
    seg = {}
    if segments:  # two packed sequences a row
        seg = {name: torch.from_numpy(np.repeat(
            (np.arange(n) >= n // 3)[None].astype(np.int32), b, 0))
            for name, n in (("q_seg", lq), ("kv_seg", lk))}
    return q, k, v, g, bias, seg, causal, 1.0 / np.sqrt(d), \
        SEED if p else None, p


def _forward(q, k, v, bias, seg, causal, scale, seed, p):
    """The plain forward on the 16-bit values in f32: out, m, l."""
    return tfa.attention_reference(q.float(), k.float(), v.float(), causal,
                                   scale, bias, p, seed, True, **seg)


def _top_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_bwd16_order_matches_the_plain_backward(case, dtype):
    """dq, dk and dv in the kernel's order within TOP_TOL of each output's
    largest gradient of the plain backward (f32 math on the same 16-bit
    inputs and the forward's 16-bit output), the bias gradient within
    1e-5, and the fully masked record's gradients exactly zero."""
    q, k, v, g, bias, seg, causal, scale, seed, p = _inputs(case, dtype)
    out, m, l = _forward(q, k, v, bias, seg, causal, scale, seed, p)
    out = out.to(dtype)
    args = (out, m, l, causal, scale, bias, p, seed, True)
    got = tfa.attention_bwd16_model(q, k, v, g, *args, **seg)
    want = tfa.attention_bwd_reference(q.float(), k.float(), v.float(),
                                       g.float(), *args, **seg)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and torch.isfinite(x.float()).all()
        assert _top_err(x, w) <= TOP_TOL[dtype], name
        assert x[-1].float().abs().max().item() == 0.0, name
    assert _top_err(got[3], want[3]) <= DBIAS_TOL


@pytest.mark.parametrize("case,dtype", [(CASES[1], torch.bfloat16),
                                        (CASES[3], torch.float16)],
                         ids=["bf16-d64-causal-segments",
                              "f16-d128-segments"])
def test_bwd16_order_matches_jax(case, dtype, monkeypatch):
    """The same order against the JAX package's backward: ``jax.vjp`` of
    its ``flash_attention`` (the Pallas kernels in interpret mode) on the
    same 16-bit values in f32, with the same padding bias, causal mask,
    segment ids and dropout hash."""
    q, k, v, g, bias, seg, causal, scale, seed, p = _inputs(case, dtype,
                                                            seed=1)
    out, m, l = _forward(q, k, v, bias, seg, causal, scale, seed, p)
    got = tfa.attention_bwd16_model(q, k, v, g, out, m, l, causal, scale,
                                    bias, p, seed, **seg)
    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    jseg = {"q_segment_ids": jnp.asarray(seg["q_seg"].numpy()),
            "kv_segment_ids": jnp.asarray(seg["kv_seg"].numpy())}

    def fn(q, k, v):
        return jax_flash(q, k, v, causal, None, 128, 128,
                         bias=jnp.asarray(bias.numpy()), dropout_p=p,
                         dropout_seed=None if seed is None else
                         jnp.asarray(np.array(seed, np.uint32)
                                     .view(np.int32)), **jseg)

    j_out, vjp = jax.vjp(fn, *(jnp.asarray(t.float().numpy())
                               for t in (q, k, v)))
    np.testing.assert_allclose(np.asarray(j_out), out.numpy(), rtol=2e-5,
                               atol=2e-5)
    want = vjp(jnp.asarray(g.float().numpy()))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert _top_err(x, torch.from_numpy(np.asarray(w))) <= \
            TOP_TOL[dtype], name


# The f16 fine-tuning step of BERT-base (12 blocks, batch 8 x 512, no loss
# scaling; tools/flash_bwd_magnitudes.py on an NVIDIA H100): in blocks 0 to
# 10 the median nonzero |dO| is 6.6e-7 to 2.4e-6, the median of the query
# rows' largest |dS| 3.4e-8 to 1.5e-7, all but 0.01% of the nonzero dS lie
# below f16's smallest normal value (2^-14) and 63% to 95% below 2^-25,
# which rounds to zero in f16 (block 11, which takes the classifier's
# gradient first: median |dO| 7.1e-4, 98.6% below 2^-14, 0.3% below
# 2^-25).
F16_STEP_DO = 1e-6


def _small_dO_case(g_scale):
    """dq, dk and dv of the plain backward, of the lifted order and of the
    same order without the lift, at an f16 dO of ``g_scale``; the sums in
    f32 at the f16 step's |dO| (where f16 outputs are themselves
    subnormal), in f16 at 1e-4."""
    q, k, v, g, bias, seg, causal, scale, seed, p = _inputs(
        CASES[0], torch.float16, g_scale=g_scale, seed=2)
    out, m, l = _forward(q, k, v, bias, seg, causal, scale, seed, p)
    out = out.to(torch.float16)
    args = (out, m, l, causal, scale, bias, p, seed)
    want = tfa.attention_bwd_reference(q.float(), k.float(), v.float(),
                                       g.float(), *args)
    # |dS| of the case: mostly below f16's smallest normal value
    dsum = (g.float() * out.float()).sum(-1)
    ds = tfa._tile_grads(q.float(), g.float(), k.float(), v.float(), m,
                         l.clamp_min(1e-20), dsum, None, scale, bias,
                         tfa._keep_scale(seed, p, 2, 2, 256, 0, 256,
                                         q.device))[0].abs()
    assert (ds[ds > 0] < 2.0 ** -14).float().mean().item() > 0.5
    out_dtype = torch.float32 if g_scale == F16_STEP_DO else None
    lifted = tfa.attention_bwd16_model(q, k, v, g, *args,
                                       out_dtype=out_dtype)
    plain = tfa.attention_bwd16_model(q, k, v, g, *args, lift=False,
                                      out_dtype=out_dtype)
    return want, lifted, plain


def test_f16_lift_keeps_the_step_s_gradients():
    """At the f16 step's |dO| the lifted order keeps dq and dk within
    TOP_TOL of each output's largest gradient (f32 sums, before the
    outputs' own rounding to f16, whose subnormal step is all that is left
    at this size), and the same order without the lift misses it by far:
    dS rounds to f16's subnormals or to zero (a negative control)."""
    want, lifted, plain = _small_dO_case(F16_STEP_DO)
    for name, x, y, w in zip(("dq", "dk"), lifted, plain, want):
        assert _top_err(x, w) <= TOP_TOL[torch.float16], name
        assert _top_err(y, w) > 10 * TOP_TOL[torch.float16], name


def test_f16_lift_at_dO_1e4():
    """At an f16 dO of 1e-4 the outputs are f16-normal and dS lies below
    f16's normal range: the lifted order within TOP_TOL of each output's
    largest gradient in f16, the order without the lift at least twice as
    far off in dq and dk."""
    want, lifted, plain = _small_dO_case(1e-4)
    for name, x, y, w in zip(("dq", "dk", "dv"), lifted, plain, want):
        assert _top_err(x, w) <= TOP_TOL[torch.float16], name
        if name != "dv":  # P t is not lifted
            assert _top_err(y, w) > 2 * _top_err(x, w), name


def test_lift_exp_lifts_into_2_14_to_2_15():
    """The lift's exponent: x 2^e in [2^14, 2^15) for x from 2^-86 to
    2^14; 0 from 2^14 up (no lift down); 100 for 0 and f32 subnormals."""
    x = torch.tensor([2.0 ** e * f for e in range(-86, 15)
                      for f in (1.0, 1.5, 1.999)], dtype=torch.float32)
    lifted = x * torch.exp2(tfa.lift_exp(x).float())
    assert ((lifted >= 2.0 ** 14) & (lifted < 2.0 ** 15)).all()
    big = torch.tensor([2.0 ** 15, 3e38])
    assert tfa.lift_exp(big).tolist() == [0, 0]
    tiny = torch.tensor([0.0, 1e-40, 2.0 ** -126], dtype=torch.float32)
    assert tfa.lift_exp(tiny).tolist() == [100, 100, 100]
