"""The port's flash attention against the JAX package's.

On the CPU the port's wrapper runs its plain version; it is held against
the reference's ``flash_attention`` run as the Pallas kernel in interpret
mode and against ``_attention_reference``, with the reference's own
tolerance (2e-5, tests/test_flash_attention.py).  Inputs come from numpy
with a seed and go to both packages.  The CUDA kernel itself is held
against the plain version in tests/test_torch_flash_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as jattn
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


def test_plain_flash_bf16_matches_jax():
    """bf16 in, f32 math, bf16 out: both round the same f32 result once."""
    q, k, v, bias = _inputs(2, 2, 256, 256, 64, "padding", seed=7)
    as_bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tfa.flash_attention(*as_bf16, False, None,
                              bias=torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    want = _attention_reference(
        *[jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in as_bf16], False, 1.0 / 8.0, bias=jnp.asarray(bias))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2 ** -8)


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


@pytest.mark.parametrize("kwargs", [
    {"q_segment_ids": np.zeros((1, 256), np.int32),
     "kv_segment_ids": np.zeros((1, 256), np.int32),
     "dropout_p": 0.1, "dropout_seed": 0},
    {"q_segment_ids": np.zeros((1, 256), np.int32),
     "kv_segment_ids": np.zeros((1, 256), np.int32)},
])
def test_unported_features_raise(kwargs):
    """Segment ids are not ported yet, with or without dropout (which is:
    tests/test_torch_flash_backward.py)."""
    q = torch.zeros(1, 1, 256, 64)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, q, q, **kwargs)


def test_dropout_needs_a_seed():
    q = torch.zeros(1, 1, 256, 64)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(q, q, q, dropout_p=0.1)


def test_bad_bias_shape_raises():
    q = torch.zeros(2, 2, 256, 64)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, bias=torch.zeros(3, 1, 1, 256))
