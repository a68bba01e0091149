"""The port's flash attention in training against the JAX package's:
the dropout hash, the forward with dropout and (m, l) statistics, and the
gradients.

On the CPU the port's ``flash_attention`` runs its plain forward and plain
backward (the arithmetic of the CUDA kernels, which
tests/test_torch_training_kernels.py holds against them on a GPU).  The
reference runs its Pallas kernels in interpret mode
(``ZOO_FLASH_INTERPRET=1``), so its gradients come from
``_flash_bwd_pallas``.  Inputs come from numpy with a seed, and both sides
get the same explicit dropout seed pair.  Tolerance: f32, 1e-4 (both sum in
f32, in different orders; measured ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.pallas import flash_attention as jfa
from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.ops import attention as tattn
from analytics_zoo_tpu_torch.ops.cuda import flash_attention as tfa

TOL = 1e-4
FINFO_MIN = float(np.finfo(np.float32).min)
SEED = (-1234567, 987654321)  # int32 bit patterns, as JAX holds them


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")


@pytest.mark.parametrize("s0,s1", [(0, 0), (7, -3), (-2 ** 31, 2 ** 31 - 1),
                                   SEED])
def test_keep_bits_is_bit_exact(s0, s1):
    b = np.arange(3)[:, None, None, None]
    h = np.arange(5)[None, :, None, None]
    q = np.array([0, 1, 255, 65535, 65536, 2 ** 20 + 3])[None, None, :, None]
    k = np.array([0, 7, 65536, 99999, 2 ** 24 - 1])[None, None, None, :]
    want = np.asarray(jfa._keep_bits(np.int32(s0), np.int32(s1), b, h, q, k))
    got = tfa.keep_bits(s0, s1, *(torch.from_numpy(a) for a in (b, h, q, k)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(tfa.keep_bits(s0, s1, 2, 4, 65536, 99999)) == int(
        want[2, 4, 4, 3])


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.9999999999])
def test_threshold_and_seeds_match_jax(p):
    assert tfa.drop_threshold(p) == int(jfa._drop_threshold(p))
    for seed in (5, -5, [3, -4], np.array([2 ** 31 - 1], np.int64)):
        want = np.asarray(jfa._normalize_seed(
            seed if not isinstance(seed, list) else np.array(seed, np.int32)))
        assert tfa.normalize_seed(seed) == tuple(
            int(x) & 0xFFFFFFFF for x in want)
    gen = engine.make_generator(2 ** 40 + 17)
    assert tfa.normalize_seed(gen) == engine.seed_pair(gen) == (17, 256)


def _inputs(b, h, lq, lk, d, bias_kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32)
               for n in (lq, lk, lk))
    g = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    bias = None
    if bias_kind == "padding":
        lengths = rng.integers(lk // 4, lk + 1, b)
        keep = (np.arange(lk)[None, :] < lengths[:, None]).astype(np.float32)
        keep[-1] = 0.0
        bias = ((1.0 - keep) * FINFO_MIN)[:, None, None, :]
    elif bias_kind == "rows":
        bias = rng.normal(size=(b, 1, 1, lk)).astype(np.float32)
    elif bias_kind == "heads":
        bias = rng.normal(size=(1, h, 1, lk)).astype(np.float32)
    return q, k, v, g, bias


# (b, h, lq, lk, d, causal, bias kind, dropout)
CASES = {
    "padding_dropout": (2, 2, 256, 256, 64, False, "padding", 0.1),
    "row_bias_grad_dropout": (1, 2, 256, 256, 64, False, "rows", 0.1),
    "causal_ragged_dropout": (1, 2, 256, 300, 64, True, None, 0.2),
    "head_bias_grad_d128": (1, 2, 256, 256, 128, False, "heads", 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_with_dropout_and_stats_matches_jax(case):
    b, h, lq, lk, d, causal, bias_kind, p = CASES[case]
    q, k, v, _, bias = _inputs(b, h, lq, lk, d, bias_kind, 1)
    scale = 1.0 / np.sqrt(d)
    seed = tfa.normalize_seed(np.array(SEED, np.int32))
    out, m, l = tfa.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, scale,
        None if bias is None else torch.from_numpy(bias), p, seed,
        return_stats=True)
    want = jfa._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, 128,
        128, interpret=True,
        bias=None if bias is None else jnp.asarray(bias), dropout_p=p,
        seed=jnp.asarray(SEED, jnp.int32), return_stats=True)
    for got, w in zip((out, m, l), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    if bias_kind == "padding":
        np.testing.assert_array_equal(out[-1].numpy(), 0.0)
        np.testing.assert_array_equal(l[-1].numpy(), 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case, interpret):
    """dq, dk, dv and the bias gradient through both packages' autograd;
    the JAX backward is the Pallas ``_flash_bwd_pallas`` in interpret
    mode."""
    b, h, lq, lk, d, causal, bias_kind, p = CASES[case]
    q, k, v, g, bias = _inputs(b, h, lq, lk, d, bias_kind, 2)
    bias_grad = bias_kind in ("rows", "heads")
    before = jfa.invocation_counts["pallas"]

    def jax_fn(q, k, v, bias):
        return jfa.flash_attention(q, k, v, causal, None, 128, 128,
                                   bias=bias, dropout_p=p,
                                   dropout_seed=jnp.asarray(SEED, jnp.int32))

    jb = None if bias is None else jnp.asarray(bias)
    out, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v), jb)
    want = vjp(jnp.asarray(g))
    assert jfa.invocation_counts["pallas"] >= before + 2  # fwd and bwd

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(
        bias_grad)
    got = tfa.flash_attention(tq, tk, tv, causal, None, bias=tb,
                              dropout_p=p,
                              dropout_seed=np.array(SEED, np.int32))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=TOL, atol=TOL)
    for t, w in zip((tq, tk, tv), want[:3]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    if bias_grad:
        assert tb.grad.shape == bias.shape
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[3]),
                                   rtol=TOL, atol=TOL * 10)
    if bias_kind == "padding":
        # a fully masked row: zero output and zero gradients
        for t in (got.detach(), tq.grad, tk.grad, tv.grad):
            np.testing.assert_array_equal(t[-1].numpy(), 0.0)


def test_dropout_mask_is_the_references():
    """The keep mask on a (B, H, Lq, Lk) grid is the reference's, bit for
    bit, and about 1 - p of it is kept."""
    b, h, lq, lk, p = 2, 3, 64, 96, 0.1
    seed = tfa.normalize_seed(np.array(SEED, np.int32))
    got = tfa._keep_mask(seed, p, b, h, lq, lk, "cpu").numpy()
    bits = jfa._keep_bits(
        jnp.int32(SEED[0]), jnp.int32(SEED[1]),
        jnp.arange(b)[:, None, None, None], jnp.arange(h)[None, :, None, None],
        jnp.arange(lq)[None, None, :, None],
        jnp.arange(lk)[None, None, None, :])
    want = np.asarray(bits >= jfa._drop_threshold(p))
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - p)) < 0.01


def test_attention_dropout_routes_like_jax(interpret):
    """dot_product_attention with dropout and a generator: the flash route
    keys the kernel's hash with the generator's seed pair, which gives the
    reference's output for the same pair; the dense route draws from the
    generator and is reproducible with it."""
    q, k, v, _, bias = _inputs(2, 2, 256, 256, 64, "padding", 3)
    tq, tk, tv, tbias = (torch.from_numpy(a) for a in (q, k, v, bias))
    gen = engine.fold_in(engine.make_generator(11), 3)
    got = tattn.dot_product_attention(tq, tk, tv, mask=tbias, dropout_p=0.1,
                                      rng=gen)
    pair = engine.seed_pair(gen)
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, None,
        bias=jnp.asarray(bias), dropout_p=0.1,
        dropout_seed=jnp.asarray(np.array(pair, np.uint32).view(np.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    short = [t[:, :, :64] for t in (tq, tk, tv)]
    dense = tattn.dot_product_attention(*short, dropout_p=0.5, rng=gen)
    again = tattn.dot_product_attention(*short, dropout_p=0.5,
                                        rng=engine.fold_in(
                                            engine.make_generator(11), 3))
    plain = tattn.dot_product_attention(*short)
    torch.testing.assert_close(dense, again)
    assert not torch.allclose(dense, plain)


def test_generators_fold_in_like_keys():
    """fold_in derives children from the seed alone, on the parent's
    device; the step generator is fold_in(seed, step)."""
    root = engine.make_generator(5)
    a, b = engine.fold_in(root, 1), engine.fold_in(root, 1)
    assert a.initial_seed() == b.initial_seed() != \
        engine.fold_in(root, 2).initial_seed()
    assert a.device == root.device
    assert engine.step_generator(5, 3).initial_seed() == \
        engine.fold_in(root, 3).initial_seed()
    assert torch.rand(4, generator=root).shape == (4,)
    assert engine.fold_in(root, 1).initial_seed() == a.initial_seed()
