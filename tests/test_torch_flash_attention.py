"""The port's flash attention against the JAX package's.

On the CPU the port's wrapper runs its plain version; it is held against
the reference's ``flash_attention`` run as the Pallas kernel in interpret
mode and against ``_attention_reference``, with the reference's own
tolerance (2e-5, tests/test_flash_attention.py).  Inputs come from numpy
with a seed and go to both packages.  The CUDA kernel itself is held
against the plain version in tests/test_torch_flash_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as jattn
from analytics_zoo_tpu.ops.pallas import flash_attention as jfa
from analytics_zoo_tpu.ops.pallas.flash_attention import (
    _attention_reference,
    flash_attention as jax_flash,
)
from analytics_zoo_tpu_torch.ops import attention as tattn
from analytics_zoo_tpu_torch.ops.cuda import flash_attention as tfa

TOL = 2e-5
FINFO_MIN = float(np.finfo(np.float32).min)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _padding_bias(b, lk, seed):
    """BERT-style (B, 1, 1, Lk) mask bias; the last batch row is fully
    masked (a bucket's zero padding record)."""
    lengths = np.random.default_rng(seed).integers(lk // 4, lk + 1, b)
    keep = (np.arange(lk)[None, :] < lengths[:, None]).astype(np.float32)
    keep[-1] = 0.0
    return ((1.0 - keep) * FINFO_MIN)[:, None, None, :]


CASES = {
    # name: (b, h, lq, lk, d, causal, bias kind)
    "bert_padding_mask": (2, 2, 256, 256, 64, False, "padding"),
    "causal_lq_lt_lk": (1, 2, 200, 300, 64, True, None),
    "causal_lq_gt_lk_ragged": (2, 1, 300, 173, 64, True, "padding"),
    "ragged_lk_full_bias": (1, 2, 256, 301, 128, False, "full"),
    "head_bias": (2, 2, 128, 130, 64, False, "heads"),
}


def _inputs(b, h, lq, lk, d, bias_kind, seed=0):
    q = _rand((b, h, lq, d), seed)
    k = _rand((b, h, lk, d), seed + 1)
    v = _rand((b, h, lk, d), seed + 2)
    bias = None
    if bias_kind == "padding":
        bias = _padding_bias(b, lk, seed + 3)
    elif bias_kind == "full":
        bias = _rand((b, 1, lq, lk), seed + 3, 2.0)
    elif bias_kind == "heads":
        bias = _rand((1, h, 1, lk), seed + 3, 2.0)
    return q, k, v, bias


def _port(q, k, v, causal, bias):
    return tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, None, bias=None if bias is None else torch.from_numpy(bias)
    ).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_jax(case, monkeypatch):
    b, h, lq, lk, d, causal, bias_kind = CASES[case]
    q, k, v, bias = _inputs(b, h, lq, lk, d, bias_kind)
    got = _port(q, k, v, causal, bias)
    jb = None if bias is None else jnp.asarray(bias)
    want_ref = _attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal,
                                    1.0 / np.sqrt(d), bias=jb)
    np.testing.assert_allclose(got, np.asarray(want_ref), rtol=TOL, atol=TOL)
    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    want_kernel = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, None, 128, 128, bias=jb)
    np.testing.assert_allclose(got, np.asarray(want_kernel), rtol=TOL,
                               atol=TOL)
    if bias_kind == "padding":
        # the fully masked row comes out as zeros, not a uniform average
        np.testing.assert_array_equal(got[-1], 0.0)
    if causal and lq > lk:
        # queries before the end-aligned diagonal see no key
        np.testing.assert_array_equal(got[:, :, :lq - lk], 0.0)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2 ** -8),
                                       ("float16", 2 ** -11)],
                         ids=["bf16", "f16"])
def test_plain_flash_bf16_matches_jax(dtype, tol):
    """16-bit in, f32 math, 16-bit out: both round the same f32 result once,
    so they agree within one step of the type (bf16 2**-8, f16 2**-11
    relative; the outputs here lie below 2)."""
    q, k, v, bias = _inputs(2, 2, 256, 256, 64, "padding", seed=7)
    as16 = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    got = tfa.flash_attention(*as16, False, None,
                              bias=torch.from_numpy(bias))
    assert got.dtype == getattr(torch, dtype)
    want = _attention_reference(
        *[jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
          for t in as16], False, 1.0 / 8.0, bias=jnp.asarray(bias))
    assert want.dtype == getattr(jnp, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("q_shape,mask_shape,mask_ndim,k_len", [
    ((2, 12, 512, 64), (2, 1, 1, 512), 4, 512),
    ((2, 12, 512, 64), None, None, 512),
    ((2, 12, 128, 64), None, None, 128),
    ((2, 12, 512, 40), None, None, 512),
    ((2, 12, 512, 64), (3, 1, 1, 512), 4, 512),
    ((2, 12, 512, 64), (512, 512), 2, 512),
    ((2, 12, 300, 128), (1, 12, 300, 301), 4, 301),
])
def test_flash_eligible_matches_jax(q_shape, mask_shape, mask_ndim, k_len):
    args = (q_shape, mask_shape, mask_ndim, 0.0, False, k_len)
    assert tattn.flash_eligible(*args) == jattn.flash_eligible(*args)
    assert not tattn.flash_eligible(*args, use_flash=False)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_route_matches_jax(causal):
    """Short sequences take the dense path in both packages: a fully
    masked row is the softmax's uniform row there, not zeros."""
    q, k, v, bias = _inputs(2, 2, 96, 96, 64, "padding", seed=11)
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(bias), causal=causal).numpy()
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(bias), causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    if not causal:
        np.testing.assert_allclose(got[-1], np.broadcast_to(
            v[-1].mean(axis=1, keepdims=True), got[-1].shape), atol=1e-5)


def test_boolean_mask_routes_like_jax(monkeypatch):
    q, k, v, _ = _inputs(1, 2, 256, 256, 64, None, seed=13)
    keep = np.random.default_rng(14).random((1, 1, 256, 256)) > 0.3
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(keep)).numpy()
    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(keep))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def _segments(b, n, lengths_per_row, seed):
    """(B, n) packed-sequence ids: each row cut into segments of the given
    lengths (the rest of the row is one more segment)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, n), np.int32)
    for row in range(b):
        cuts = np.cumsum(rng.permutation(lengths_per_row))
        ids[row] = np.searchsorted(cuts, np.arange(n), side="right")
    return ids


# name: (b, h, lq, lk, d, causal, bias kind, segment lengths, dropout)
SEG_CASES = {
    # the reference's training config (tests/test_flash_attention.py:225):
    # padding mask, segment ids, dropout and causal
    "training_config": (2, 2, 130, 130, 64, True, "pad_1e30", None, 0.2),
    "packed_rows_head_bias": (2, 2, 256, 256, 64, False, "heads",
                              (40, 100, 60), 0.0),
    "ragged_lq_lt_lk_d128": (1, 2, 200, 256, 128, False, "padding",
                             (90, 70), 0.1),
}


def _seg_inputs(case, seed=21):
    b, h, lq, lk, d, causal, bias_kind, lengths, p = SEG_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, n, d)).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    bias = None
    if bias_kind == "pad_1e30":
        keep = np.ones((b, 1, 1, lk), np.float32)
        keep[:, :, :, 100:] = 0.0
        bias = (1.0 - keep) * np.float32(-1e30)
    elif bias_kind == "padding":
        bias = _padding_bias(b, lk, seed + 1)
    elif bias_kind == "heads":
        bias = rng.normal(size=(1, h, 1, lk)).astype(np.float32)
    if lengths is None:  # as the reference's test: two segments of 70, 60
        q_seg = kv_seg = np.repeat([[0] * 70 + [1] * 60], b, 0).astype(
            np.int32)
    else:
        q_seg = _segments(b, lq, lengths, seed + 2)
        kv_seg = _segments(b, lk, lengths, seed + 3)
    return q, k, v, g, bias, q_seg, kv_seg, causal, p


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segment_ids_forward_matches_jax(case, monkeypatch):
    """The plain forward with segment ids against the reference's Pallas
    forward in interpret mode and its ``_attention_reference``."""
    q, k, v, _, bias, q_seg, kv_seg, causal, p = _seg_inputs(case)
    seed = np.array([5, 9], np.int32)
    jb = None if bias is None else jnp.asarray(bias)
    got = tfa.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, None,
        bias=None if bias is None else torch.from_numpy(bias),
        q_segment_ids=torch.from_numpy(q_seg),
        kv_segment_ids=torch.from_numpy(kv_seg), dropout_p=p,
        dropout_seed=seed).numpy()
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    want_ref = _attention_reference(
        *args, 1.0 / np.sqrt(q.shape[-1]), bias=jb,
        q_seg=jnp.asarray(q_seg), kv_seg=jnp.asarray(kv_seg), dropout_p=p,
        seed=jnp.asarray(seed))
    np.testing.assert_allclose(got, np.asarray(want_ref), rtol=TOL, atol=TOL)
    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    want = jax_flash(*args, None, 128, 128, bias=jb,
                     q_segment_ids=jnp.asarray(q_seg),
                     kv_segment_ids=jnp.asarray(kv_seg), dropout_p=p,
                     dropout_seed=jnp.asarray(seed))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    assert np.isfinite(got).all()


# gradients: f32 sums in different orders (tests/test_torch_flash_backward.py)
GRAD_TOL = 1e-4


def _port_grads(q, k, v, g, bias, causal, p, seed, bias_grad, **seg):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(
        bias_grad)
    out = tfa.flash_attention(tq, tk, tv, causal, None, bias=tb,
                              dropout_p=p, dropout_seed=seed, **seg)
    out.backward(torch.from_numpy(g))
    grads = [tq.grad, tk.grad, tv.grad] + ([tb.grad] if bias_grad else [])
    return out.detach().numpy(), [t.numpy() for t in grads]


def _jax_grads(q, k, v, g, bias, causal, p, seed, bias_grad, **seg):
    def fn(q, k, v, bias):
        return jax_flash(q, k, v, causal, None, 128, 128, bias=bias,
                         dropout_p=p, dropout_seed=jnp.asarray(seed), **{
                             n: jnp.asarray(a) for n, a in seg.items()})

    jb = None if bias is None else jnp.asarray(bias)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jb)
    grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(t) for t in
                             grads[:4 if bias_grad else 3]]


def _assert_grads(got, want):
    (g_out, g_grads), (w_out, w_grads) = got, want
    np.testing.assert_allclose(g_out, w_out, rtol=TOL, atol=TOL)
    for i, (a, w) in enumerate(zip(g_grads, w_grads)):
        # the bias gradient sums over the broadcast dims: 10x the tolerance
        tol = GRAD_TOL * (10 if i == 3 else 1)
        assert a.shape == w.shape
        np.testing.assert_allclose(a, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segment_ids_gradients_match_jax(case, monkeypatch):
    """dq, dk, dv (and a per-head bias's gradient) through both packages'
    autograd with segment ids; the JAX backward is ``_flash_bwd_pallas`` in
    interpret mode."""
    q, k, v, g, bias, q_seg, kv_seg, causal, p = _seg_inputs(case, seed=31)
    seed = np.array([-7, 11], np.int32)
    bias_grad = case == "packed_rows_head_bias"
    seg = {"q_segment_ids": q_seg, "kv_segment_ids": kv_seg}
    got = _port_grads(q, k, v, g, bias, causal, p, seed, bias_grad,
                      **{n: torch.from_numpy(a) for n, a in seg.items()})
    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    before = jfa.invocation_counts["pallas"]
    _assert_grads(got, _jax_grads(q, k, v, g, bias, causal, p, seed,
                                  bias_grad, **seg))
    assert jfa.invocation_counts["pallas"] >= before + 2  # fwd and bwd


@pytest.mark.parametrize("d", [96, 192, 320])
def test_any_head_dim_matches_jax(d, monkeypatch):
    """The plain forward and backward at head dims other than 64 and 128
    (on a GPU the chunked tensor-core bodies' at 192 and 320, the
    CUDA-core bodies' at 96), against the reference with the padding bias
    and dropout."""
    rng = np.random.default_rng(d)
    b, h, lq, lk = 2, 2, 160, 200
    q, k, v, g = (rng.normal(size=(b, h, n, d)).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    bias = _padding_bias(b, lk, d)
    seed = np.array([3, 4], np.int32)
    got = _port_grads(q, k, v, g, bias, False, 0.1, seed, False)
    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    want = _jax_grads(q, k, v, g, bias, False, 0.1, seed, False)
    _assert_grads(got, want)
    want_ref = _attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
        1.0 / np.sqrt(d), bias=jnp.asarray(bias), dropout_p=0.1,
        seed=jnp.asarray(seed))
    np.testing.assert_allclose(got[0], np.asarray(want_ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal,p,segments", [(True, 0.0, False),
                                               (False, 0.1, True)],
                         ids=["causal", "dropout_segments"])
def test_full_bias_gradient_blockwise_matches_jax(causal, p, segments,
                                                  monkeypatch):
    """A (B, 1, Lq, Lk) bias that needs a gradient takes the blockwise
    route (key blocks of 256: Lk 300 makes two) in both packages: dq, dk,
    dv and the bias gradient against ``jax.grad``."""
    rng = np.random.default_rng(41)
    b, h, lq, lk, d = 2, 2, 140, 300, 64
    q, k, v, g = (rng.normal(size=(b, h, n, d)).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    bias = (rng.normal(size=(b, 1, lq, lk)) * 2).astype(np.float32)
    seed = np.array([8, -8], np.int32)
    seg = {}
    if segments:
        seg = {"q_segment_ids": _segments(b, lq, (50, 60), 42),
               "kv_segment_ids": _segments(b, lk, (120, 100), 43)}
    before = tfa.bwd_blockwise_count, tfa.bwd_plain_count
    got = _port_grads(q, k, v, g, bias, causal, p, seed, True,
                      **{n: torch.from_numpy(a) for n, a in seg.items()})
    assert (tfa.bwd_blockwise_count, tfa.bwd_plain_count) == \
        (before[0] + 1, before[1])
    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    _assert_grads(got, _jax_grads(q, k, v, g, bias, causal, p, seed, True,
                                  **seg))


def test_blockwise_route_matches_the_plain_backward():
    """The blockwise route and the one-tile plain backward compute the same
    gradients (the kernels' arithmetic), here with every option on."""
    rng = np.random.default_rng(51)
    b, h, lq, lk, d = 2, 3, 100, 530, 32
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(
        np.float32)) for n in (lq, lk, lk, lq))
    bias = torch.from_numpy(rng.normal(size=(1, h, lq, lk)).astype(
        np.float32))
    q_seg = torch.from_numpy(_segments(b, lq, (30, 30), 52))
    kv_seg = torch.from_numpy(_segments(b, lk, (200, 200), 53))
    seed = (17, 19)
    out, m, l = tfa.attention_reference(q, k, v, True, 0.2, bias, 0.1, seed,
                                        True, q_seg=q_seg, kv_seg=kv_seg)
    args = (q, k, v, g, out, m, l, True, 0.2, bias, 0.1, seed)
    plain = tfa.attention_bwd_reference(*args, True, q_seg=q_seg,
                                        kv_seg=kv_seg)
    blocks = tfa.attention_bwd_blockwise(*args, q_seg=q_seg, kv_seg=kv_seg)
    for a, w in zip(blocks, plain):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


def test_unmatched_segment_rows_are_zero():
    """A query whose segment has no key comes out as zeros (and its
    gradients too), not NaN, as in the reference."""
    q = torch.randn(1, 2, 256, 64, requires_grad=True)
    k = torch.randn(1, 2, 256, 64, requires_grad=True)
    q_seg = torch.zeros(1, 256, dtype=torch.int64)
    q_seg[0, :10] = 7  # segment 7 has no key
    out = tfa.flash_attention(q, k, k, q_segment_ids=q_seg,
                              kv_segment_ids=torch.zeros(1, 256,
                                                         dtype=torch.int64))
    out.sum().backward()
    assert torch.equal(out[0, :, :10], torch.zeros_like(out[0, :, :10]))
    assert torch.isfinite(out).all() and torch.isfinite(q.grad).all()
    assert torch.equal(q.grad[0, :, :10], torch.zeros_like(q.grad[0, :, :10]))


@pytest.mark.parametrize("which", ["q_segment_ids", "kv_segment_ids"])
def test_segment_ids_come_together(which):
    """One of the two raises, as in the reference (:1048-1050)."""
    q = torch.zeros(1, 1, 256, 64)
    with pytest.raises(ValueError, match="together"):
        tfa.flash_attention(q, q, q, **{which: np.zeros((1, 256), np.int32)})


def test_dropout_needs_a_seed():
    q = torch.zeros(1, 1, 256, 64)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(q, q, q, dropout_p=0.1)


def test_bad_bias_shape_raises():
    q = torch.zeros(2, 2, 256, 64)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, bias=torch.zeros(3, 1, 1, 256))
