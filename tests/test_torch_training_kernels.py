"""The port's training kernels and their dispatch, without JAX.

The ``cuda``-marked tests hold each CUDA kernel of the training slice
against its plain version on a GPU and skip where none is visible:

- the flash-attention forward with dropout and (m, l) statistics, and the
  flash-attention backward (dq, dk, dv, bias-gradient partials): head dims
  64 and 128, padding, per-head and full biases, causal with lq < lk and
  lq > lk, dropout 0.1, a fully masked row; f32 within 2e-4 of the plain
  version (relative to the largest value when it exceeds 1: both sum
  512-long products in f32, in different orders), bf16 inputs within
  2e-2 and f16 inputs within 4e-3 of the plain version run in f32 (the
  forward computes in f32 and rounds P and the output to the input type:
  8 significant bits in bf16, 11 in f16; the 16-bit backward rounds P t,
  dS and the gradients); the 16-bit backward also within 1.6e-2 (bf16)
  and 2e-3 (f16) of each output's largest gradient of the plain version fed
  the same inputs, also with an f16 dO of 1e-4 (where dS falls below f16's
  normal range), and bit for bit the same in two calls;
- the f32 forward on the tensor cores (3xTF32) within 1e-4 of the plain
  version on every case and at head dims 192 to 1024 (the chunked
  tensor-core body, also in bf16 and f16 within their tolerances), and
  the f32
  backward within 1e-5 of the largest gradient, fed the same forward
  outputs as its plain version, on every case and at head dims 192, 256
  and 384 (the chunked tensor-core body);
- every body of both kernels with segment ids (2-4 packed sequences a
  row), causal masking, the padding bias and dropout 0.1, at head dims 64
  and 128 (tensor cores in both), 192, 256, 320 and 512 (the chunked
  tensor-core bodies) and 96 (CUDA cores in both), f32, bf16 and f16,
  within the tolerances above;
- the gradient of a full bias through autograd: the blockwise route,
  against the plain backward;
- one ``fit`` step of a BERT classifier with head dim 192 (hidden 384, 2
  heads) on the GPU against the same step on the CPU;
- ``fit`` under ``mixed_precision()`` (hidden 128, head dim 64): every
  flash launch on bf16 q/k/v, f32 masters and moments; then under
  ``plan="dp+f16"``: every flash launch on f16 q/k/v, finite losses, the
  masters and moments still f32;
- the fused Adam update over leaves of odd sizes, within 1e-6 relative
  (the kernel rounds each operation as the plain formula does), and over
  whole trees (BERT-base's leaf shapes; odd sizes and unaligned views):
  one launch, bit for bit the plain version's outputs;
- the fused softmax cross-entropy forward and backward at the classifier
  head (8, 2) and an LM head (4096, 30522), within 1e-5 (f32 sums over the
  vocab in different orders), f32, bf16 and f16 logits (the gradient in
  the logits' type: within one step of it, 1e-2 in bf16, 2e-3 in f16).

This file imports nothing from the JAX package, so on a machine with a GPU
and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_training_kernels.py

The other tests check on the CPU that the wrappers never fall back: a
tensor on a CUDA device goes to the kernel or raises.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops.cuda import flash_attention as tfa
from analytics_zoo_tpu_torch.ops.cuda import fused_adam as tadam
from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as txent

F32_TOL = 2e-4
BF16_TOL = 2e-2
F16_TOL = 4e-3
# the 16-bit backward against the plain version fed the same inputs,
# relative to each output's largest gradient: four units of roundoff of the
# input type (P t, dS and the outputs rounded to 8 significant bits in
# bf16, 11 in f16), the bounds of the CPU model of its order
# (tests/test_torch_bwd16_order.py)
TOP_TOL = {torch.bfloat16: 4 * 2.0 ** -8, torch.float16: 4 * 2.0 ** -11}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _attn_inputs(b, h, lq, lk, d, bias_kind, device, seed=0, layout=None):
    """q, k, v as split_heads views (non-contiguous rows), as the model
    hands them over; ``layout`` "fused": views of one fused (B, L, 3 H D)
    projection (lq == lk); "misaligned": q's base and row stride not
    multiples of 16 bytes."""
    gen = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (gen.normal(size=shape) * scale).astype(np.float32)).to(device)

    q = t((b, lq, h, d)).transpose(1, 2)
    k = t((b, lk, h, d)).transpose(1, 2)
    v = t((b, lk, h, d)).transpose(1, 2)
    if layout == "fused":
        q, k, v = (x.reshape(b, lq, h, d).transpose(1, 2) for x in
                   torch.chunk(t((b, lq, 3 * h * d)), 3, dim=-1))
    elif layout == "misaligned":
        wide = torch.zeros(b, h, lq, d + 1, device=device)
        wide[..., 1:] = q
        q = wide[..., 1:]
    g = t((b, h, lq, d))
    bias = None
    if bias_kind == "padding":
        lengths = gen.integers(lk // 4, lk + 1, b)
        keep = (np.arange(lk)[None, :] < lengths[:, None]).astype(np.float32)
        keep[-1] = 0.0
        bias = torch.from_numpy(((1.0 - keep) * np.finfo(np.float32).min)
                                [:, None, None, :]).to(device)
    elif bias_kind == "full":
        bias = t((b, 1, lq, lk), 2.0)
    elif bias_kind == "heads":
        bias = t((1, h, 1, lk), 2.0)
    return q, k, v, g, bias


def _close(got, want, tol):
    scale = max(1.0, want.abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= tol * scale, (err, tol * scale)


def _close_to_top(got, want, tol):
    """Within ``tol`` of the largest gradient of ``want``, however small
    that is (``_close`` holds gradients below 1 to an absolute bound)."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= tol * top, (err, tol * top)


# (b, h, lq, lk, d, causal, bias kind, bias needs grad, dropout)
ATTN_CASES = [
    (8, 12, 512, 512, 64, False, "padding", False, 0.1),  # BERT-base train
    (2, 4, 448, 500, 64, True, None, False, 0.1),         # end-aligned
    (2, 2, 300, 173, 128, True, "padding", True, 0.0),    # lq > lk
    (1, 2, 256, 301, 128, False, "full", False, 0.1),
    (2, 2, 130, 200, 64, False, "heads", True, 0.1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL),
                                       (torch.float16, F16_TOL)],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_fwd_bwd_kernels_match_plain(case, dtype, tol, cuda_device):
    b, h, lq, lk, d, causal, bias_kind, bias_grad, p = case
    q, k, v, g, bias = _attn_inputs(b, h, lq, lk, d, bias_kind, cuda_device)
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    seed = (0x1234ABCD, 0x9E3779B9) if p > 0 else None
    scale = 1.0 / np.sqrt(d)
    before = tfa.launch_count, tfa.bwd_launch_count
    out, m, l = tfa._flash_cuda(q, k, v, causal, scale, bias, p, seed,
                                stats=True)
    dq, dk, dv, db = tfa._flash_bwd_cuda(q, k, v, g, out, m, l, causal,
                                         scale, bias, p, seed, bias_grad)
    torch.cuda.synchronize()
    assert (tfa.launch_count, tfa.bwd_launch_count) == \
        (before[0] + 1, before[1] + 1)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    w_out, w_m, w_l = tfa.attention_reference(
        qf, kf, vf, causal, scale, bias, p, seed, return_stats=True)
    _close(out, w_out, tol)
    assert out.dtype == dtype and dq.dtype == dtype
    torch.testing.assert_close(m, w_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, w_l, rtol=1e-4, atol=1e-5)
    want = tfa.attention_bwd_reference(
        qf, kf, vf, gf, w_out, w_m, w_l, causal, scale, bias, p, seed,
        bias_grad)
    for got_t, want_t in zip((dq, dk, dv), want[:3]):
        _close(got_t, want_t, tol)
    if bias_grad:
        assert db.shape == bias.shape
        _close(db, want[3], tol)
    if dtype != torch.float32:
        # the 16-bit backward against the plain version fed its own inputs
        # (the forward's 16-bit output), relative to the largest gradient
        same = tfa.attention_bwd_reference(
            qf, kf, vf, gf, out.float(), m, l, causal, scale, bias, p, seed,
            bias_grad)
        for got_t, want_t in zip((dq, dk, dv), same[:3]):
            _close_to_top(got_t, want_t, TOP_TOL[dtype])
    if bias_kind == "padding":
        # the fully masked batch row: zero output, zero gradients
        for t in (out, dq, dk, dv):
            assert t[-1].float().abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd16_is_deterministic(d, dtype, cuda_device):
    """Two calls of the 16-bit backward give the same bits: each output
    element is written once by one thread, summed in one order, with no
    atomics (padding bias with its gradient, dropout 0.1)."""
    q, k, v, g, bias = _attn_inputs(2, 128 // d * 3, 512, 512, d, "padding",
                                    cuda_device, seed=d)
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    seed, scale = (0x1234ABCD, 0x9E3779B9), 1.0 / np.sqrt(d)
    out, m, l = tfa._flash_cuda(q, k, v, False, scale, bias, 0.1, seed,
                                stats=True)
    args = (q, k, v, g, out, m, l, False, scale, bias, 0.1, seed, True)
    first = tfa._flash_bwd_cuda(*args)
    second = tfa._flash_bwd_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_f16_small_grads_within_top_tol(d, cuda_device):
    """An f16 dO of ~1e-4, where dS falls below f16's smallest normal value
    (2^-14) and would keep few bits, or none, if it were rounded as it is:
    dq, dk and dv within 2e-3 of each output's largest gradient of the
    plain version fed the same inputs, the fully masked record's gradients
    exactly zero."""
    q, k, v, g, bias = _attn_inputs(4, 768 // d, 512, 512, d, "padding",
                                    cuda_device, seed=11)
    q, k, v = (x.to(torch.float16) for x in (q, k, v))
    g = (g * 1e-4).to(torch.float16)
    seed, scale = (0x1234ABCD, 0x9E3779B9), 1.0 / np.sqrt(d)
    out, m, l = tfa._flash_cuda(q, k, v, False, scale, bias, 0.1, seed,
                                stats=True)
    args = (q, k, v, g, out, m, l, False, scale, bias, 0.1, seed)
    got = tfa._flash_bwd_cuda(*args)
    want = tfa.attention_bwd_reference(*(x.float() for x in args[:5]),
                                       *args[5:])
    torch.cuda.synchronize()
    for got_t, want_t in zip(got[:3], want[:3]):
        _close_to_top(got_t, want_t, TOP_TOL[torch.float16])
        assert got_t[-1].float().abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_through_autograd(cuda_device):
    """The autograd Function launches one forward and one backward."""
    q, k, v, g, bias = _attn_inputs(2, 2, 256, 256, 64, "heads",
                                    cuda_device, seed=3)
    q, k, v, bias = (x.detach().requires_grad_() for x in (q, k, v, bias))
    before = tfa.launch_count, tfa.bwd_launch_count
    out = tfa.flash_attention(q, k, v, False, None, bias=bias,
                              dropout_p=0.1, dropout_seed=(5, 6))
    out.backward(g)
    torch.cuda.synchronize()
    assert (tfa.launch_count, tfa.bwd_launch_count) == \
        (before[0] + 1, before[1] + 1)
    assert bias.grad.shape == bias.shape
    # the gradient of a full bias: the blockwise route, not the kernel
    gen = np.random.default_rng(4)
    full = torch.from_numpy(gen.normal(size=(2, 1, 256, 256)).astype(
        np.float32)).to(cuda_device).requires_grad_()
    for t in (q, k, v):
        t.grad = None
    before = (tfa.launch_count, tfa.bwd_launch_count,
              tfa.bwd_blockwise_count)
    out = tfa.flash_attention(q, k, v, False, None, bias=full,
                              dropout_p=0.1, dropout_seed=(5, 6))
    out.backward(g)
    torch.cuda.synchronize()
    assert (tfa.launch_count, tfa.bwd_launch_count,
            tfa.bwd_blockwise_count) == (before[0] + 1, before[1],
                                         before[2] + 1)
    scale = 1.0 / np.sqrt(64)
    w_out, w_m, w_l = tfa.attention_reference(
        q.detach(), k.detach(), v.detach(), False, scale, full.detach(),
        0.1, (5, 6), return_stats=True)
    want = tfa.attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), g, w_out, w_m, w_l, False, scale,
        full.detach(), 0.1, (5, 6), True)
    for got_t, want_t in zip((q.grad, k.grad, v.grad, full.grad), want):
        assert got_t.shape == want_t.shape
        _close(got_t, want_t, F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 129, 1000, 4099, 12345, 768 * 3072 + 1])
def test_adam_kernel_matches_plain(n, cuda_device):
    gen = np.random.default_rng(n)

    def t(scale=1.0):
        return torch.from_numpy(
            (gen.normal(size=n) * scale).astype(np.float32)).to(cuda_device)

    g, mu, nu = t(), t(0.1), t(0.01).abs()
    scalars = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 1 - 0.9 ** 3,
                            1 - 0.999 ** 3], dtype=torch.float32,
                           device=cuda_device)
    before = tadam.launch_count
    got = tadam.adam_leaf(g, mu, nu, scalars)
    torch.cuda.synchronize()
    assert tadam.launch_count == before + 1
    for a, w in zip(got, tadam.adam_leaf_reference(g, mu, nu, scalars)):
        assert ((a - w).abs().max() <= 1e-6 * w.abs().max()).item()


# f32 backward against the plain version fed the same forward outputs,
# relative to the largest gradient: 3xTF32 products are f32 math to
# ~2^-21 relative each, summed in fresh accumulators per 32-row tile
F32_BWD_TOL = 1e-5
# the chunked tensor-core backward (head dims above 128): one and two
# column slices a block, causal with lq < lk and lq > lk, the padding bias
# with its row gradient, a per-head bias, dropout 0.1
WIDE_BWD_CASES = [
    (2, 4, 512, 512, 192, False, "padding", True, 0.1),   # 4-head BERT
    (2, 3, 448, 500, 256, True, "padding", True, 0.1),
    (2, 2, 300, 173, 384, True, "padding", True, 0.0),
    (1, 2, 256, 301, 384, False, "heads", True, 0.1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES + WIDE_BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_bwd_f32_within_1e5_of_largest_gradient(case, cuda_device):
    b, h, lq, lk, d, causal, bias_kind, bias_grad, p = case
    q, k, v, g, bias = _attn_inputs(b, h, lq, lk, d, bias_kind, cuda_device,
                                    seed=7)
    seed = (0x1234ABCD, 0x9E3779B9) if p > 0 else None
    scale = 1.0 / np.sqrt(d)
    out, m, l = tfa._flash_cuda(q, k, v, causal, scale, bias, p, seed,
                                stats=True)
    args = (q, k, v, g, out, m, l, causal, scale, bias, p, seed, bias_grad)
    got = tfa._flash_bwd_cuda(*args)
    want = tfa.attention_bwd_reference(*args)
    torch.cuda.synchronize()
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            continue
        err = (x - w).abs().max().item()
        top = w.abs().max().item()
        assert torch.isfinite(x).all() and err <= F32_BWD_TOL * top, \
            (name, err, top)


# the chunked tensor-core forward (head dims above 128 that are multiples
# of 64): one to four column slices a block, two and three warpgroups of
# 64 or (f32) 128 columns, bf16 with Q kept whole and (at 1024) streamed,
# causal with lq > lk and lq < lk, the padding and per-head bias rows, a
# full bias read element by element, dropout 0.1 with (m, l), views of one
# fused projection, and an input the wrapper copies for the tensor copies;
# (b, h, lq, lk, d, causal, bias kind, -, dropout[, layout])
WIDE_FWD_CASES = [
    (2, 4, 512, 512, 192, False, "padding", False, 0.1, "fused"),
    (2, 3, 448, 500, 256, True, None, False, 0.0),
    (2, 2, 300, 173, 320, True, "padding", False, 0.1),
    (1, 2, 256, 301, 384, False, "full", False, 0.1),
    (2, 2, 130, 200, 512, False, "heads", False, 0.0),
    (1, 1, 200, 260, 768, True, "padding", False, 0.1),
    (2, 2, 256, 256, 384, False, "padding", False, 0.0, "misaligned"),
    (1, 2, 200, 160, 1024, True, "heads", False, 0.1),  # bf16: Q streamed
]


def _case_id(c):
    return "x".join(map(str, c))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,dtype",
    [pytest.param(c, torch.float32, id=_case_id(c))
     for c in ATTN_CASES + WIDE_FWD_CASES]
    + [pytest.param(c, torch.bfloat16, id=_case_id(c) + "-bf16")
       for c in WIDE_FWD_CASES]
    + [pytest.param(c, torch.float16, id=_case_id(c) + "-f16")
       for c in WIDE_FWD_CASES])
def test_flash_fwd_f32_tensor_cores_within_1e4(case, dtype, cuda_device):
    """The f32 forward runs 3xTF32 on the tensor cores at every multiple of
    64 (head dims 64 and 128 whole, above 128 in 32-column chunks): out
    within 1e-4 of the plain version (measured ~1e-6), m and l as the plain
    version's.  The chunked body's bf16 and f16 instances (wgmma of that
    type) are held to their tolerances against the plain version run in
    f32."""
    b, h, lq, lk, d, causal, bias_kind, _, p, *layout = case
    q, k, v, _, bias = _attn_inputs(b, h, lq, lk, d, bias_kind, cuda_device,
                                    seed=9, layout=(layout or [None])[0])
    q, k, v = (x.to(dtype) for x in (q, k, v))
    seed = (0x1234ABCD, 0x9E3779B9) if p > 0 else None
    scale = 1.0 / np.sqrt(d)
    for stats in (False, True):
        before = tfa.launch_count
        out, m, l = tfa._flash_cuda(q, k, v, causal, scale, bias, p, seed,
                                    stats=stats)
        w_out, w_m, w_l = tfa.attention_reference(
            q.float(), k.float(), v.float(), causal, scale, bias, p, seed,
            return_stats=True)
        torch.cuda.synchronize()
        assert tfa.launch_count == before + 1 and out.dtype == dtype
        tol = {torch.float32: 1e-4, torch.bfloat16: BF16_TOL,
               torch.float16: F16_TOL}[dtype]
        if dtype == torch.float32:
            err = (out - w_out).abs().max().item()
            assert torch.isfinite(out).all() and err <= tol, err
        else:
            _close(out, w_out, tol)
        if stats:
            torch.testing.assert_close(m, w_m, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(l, w_l, rtol=tol, atol=1e-5)
        if bias_kind == "padding":  # the fully masked batch row
            assert out[-1].float().abs().max().item() == 0.0


def _segment_ids(b, n, gen, device):
    """(B, n) packed-sequence ids: 2 to 4 sequences a row."""
    ids = np.zeros((b, n), np.int32)
    for row in range(b):
        cuts = np.sort(gen.choice(np.arange(1, n), gen.integers(1, 4),
                                  replace=False))
        ids[row] = np.searchsorted(cuts, np.arange(n), side="right")
    return torch.from_numpy(ids).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL),
                                       (torch.float16, F16_TOL)],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d", [64, 96, 128, 192, 256, 320, 512])
def test_flash_every_body_with_segments(d, dtype, tol, cuda_device):
    """Forward (with statistics) and backward of every kernel body with
    segment ids, causal masking (lq < lk), the padding bias, a per-head
    bias gradient and dropout 0.1: the tensor-core bodies at head dims 64
    and 128, the chunked tensor-core bodies at the other multiples of 64
    and both CUDA-core bodies at 96."""
    gen = np.random.default_rng(d)
    b, h, lq, lk = 2, 3, 200, 260
    q, k, v, g, bias = _attn_inputs(b, h, lq, lk, d, "padding", cuda_device,
                                    seed=d)
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    q_seg = _segment_ids(b, lq, gen, cuda_device)
    kv_seg = _segment_ids(b, lk, gen, cuda_device)
    seg = {"q_seg": q_seg, "kv_seg": kv_seg}
    seed, scale = (0x1234ABCD, 0x9E3779B9), 1.0 / np.sqrt(d)
    before = tfa.launch_count, tfa.bwd_launch_count
    out, m, l = tfa._flash_cuda(q, k, v, True, scale, bias, 0.1, seed,
                                stats=True, **seg)
    grads = tfa._flash_bwd_cuda(q, k, v, g, out, m, l, True, scale, bias,
                                0.1, seed, True, **seg)
    torch.cuda.synchronize()
    assert (tfa.launch_count, tfa.bwd_launch_count) == \
        (before[0] + 1, before[1] + 1)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    w_out, w_m, w_l = tfa.attention_reference(
        qf, kf, vf, True, scale, bias, 0.1, seed, return_stats=True, **seg)
    _close(out, w_out, tol)
    torch.testing.assert_close(m, w_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, w_l, rtol=tol, atol=1e-5)
    want = tfa.attention_bwd_reference(
        qf, kf, vf, gf, w_out, w_m, w_l, True, scale, bias, 0.1, seed, True,
        **seg)
    for got_t, want_t in zip(grads, want):
        assert got_t.shape == want_t.shape
        _close(got_t, want_t, tol)
    # the fully masked batch row: zero output, zero gradients
    for t in (out,) + grads[:3]:
        assert t[-1].float().abs().max().item() == 0.0


@pytest.mark.cuda
def test_fit_step_head_dim_192(cuda_device):
    """One ``fit`` step of a BERT classifier with head dim 192 (hidden 384,
    2 heads, 2 blocks, sequence 256) launches one forward and one backward
    flash kernel a block, and its loss and gradients match the same step
    on the CPU (f32 on both; cuBLAS, MKL and the kernels sum in different
    orders: 1e-3 relative)."""
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        get_loss,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    seq, n = 256, 4

    def model():
        ins = [Input((seq,)) for _ in range(4)]
        _, pooled = BERT(vocab=1000, hidden_size=384, n_block=2, n_head=2,
                         seq_len=seq, intermediate_size=768,
                         hidden_p_drop=0.0, attn_p_drop=0.1)(ins)
        return Model(ins, Dense(2)(pooled))

    gen = np.random.default_rng(192)
    lengths = gen.integers(64, seq + 1, n)
    pos = np.arange(seq)[None, :]
    mask = (pos < lengths[:, None]).astype(np.float32)
    x = [(gen.integers(1, 1000, (n, seq)) * mask).astype(np.int32),
         np.zeros((n, seq), np.int32), np.tile(pos.astype(np.int32), (n, 1)),
         mask]
    y = gen.integers(0, 2, n).astype(np.int32)
    init_zoo_context(seed=7, device="cuda")
    net = model()
    net.build_params(rng=torch.Generator().manual_seed(7), device="cuda")
    net.compile(optimizer=Adam(1e-4),
                loss="sparse_categorical_crossentropy_from_logits")
    before = tfa.launch_count, tfa.bwd_launch_count
    net.fit(x, y, batch_size=n, nb_epoch=1)
    torch.cuda.synchronize()
    assert (tfa.launch_count, tfa.bwd_launch_count) == \
        (before[0] + 2, before[1] + 2)
    assert np.isfinite(net._estimator.loss_log[-1][1])
    results = []
    for device in ("cuda", "cpu"):
        small = model()
        small.build_params(rng=torch.Generator().manual_seed(7),
                           device=device)
        est = Estimator(small, loss=get_loss(
            "sparse_categorical_crossentropy_from_logits"))
        loss, grads, _ = est.loss_and_grads(
            small.params, small.state,
            _to_device({"x": x, "y": y}, small.device),
            step_generator(7, 0, small.device))
        results.append((loss.item(), [t.cpu() for t in tree_leaves(grads)]))
    (g_loss, g_grads), (c_loss, c_grads) = results
    assert abs(g_loss - c_loss) <= 1e-3 * abs(c_loss)
    for a, w in zip(g_grads, c_grads):
        assert ((a - w).abs().max() <= 1e-3 * w.abs().max().clamp_min(
            1e-30)).item()


@pytest.mark.cuda
def test_fit_mixed_precision_launches_bf16_kernels(cuda_device,
                                                   monkeypatch):
    """Two ``fit`` steps of a 2-block BERT (hidden 128, 2 heads of 64,
    sequence 256) under ``mixed_precision()``: 4 forward and 4 backward
    flash launches, each on bf16 q/k/v, finite losses, f32 masters and Adam
    moments; then two more under ``plan="dp+f16"``: 4 + 4 launches, each
    on f16 q/k/v, with the same checks."""
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.parallel import mixed_precision
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    seq, n = 256, 4
    gen = np.random.default_rng(16)
    lengths = gen.integers(64, seq + 1, n)
    pos = np.arange(seq)[None, :]
    mask = (pos < lengths[:, None]).astype(np.float32)
    x = [(gen.integers(1, 1000, (n, seq)) * mask).astype(np.int32),
         np.zeros((n, seq), np.int32), np.tile(pos.astype(np.int32), (n, 1)),
         mask]
    y = gen.integers(0, 2, n).astype(np.int32)
    init_zoo_context(seed=16, device="cuda")
    ins = [Input((seq,)) for _ in range(4)]
    _, pooled = BERT(vocab=1000, hidden_size=128, n_block=2, n_head=2,
                     seq_len=seq, intermediate_size=256, hidden_p_drop=0.1,
                     attn_p_drop=0.1)(ins)
    net = Model(ins, Dense(2)(pooled))
    net.build_params()
    net.compile(optimizer=Adam(1e-4),
                loss="sparse_categorical_crossentropy_from_logits")
    seen = []
    for name in ("_flash_cuda", "_flash_bwd_cuda"):
        launch = getattr(tfa, name)

        def record(q, k, v, *args, _launch=launch, **kwargs):
            seen.append((q.dtype, k.dtype, v.dtype))
            return _launch(q, k, v, *args, **kwargs)

        monkeypatch.setattr(tfa, name, record)
    for plan, dtype in ((mixed_precision(), torch.bfloat16),
                        ("dp+f16", torch.float16)):
        seen.clear()
        before = tfa.launch_count, tfa.bwd_launch_count
        net.fit(x, y, batch_size=n // 2, nb_epoch=1, plan=plan)
        torch.cuda.synchronize()
        assert (tfa.launch_count, tfa.bwd_launch_count) == \
            (before[0] + 4, before[1] + 4)
        assert seen == [(dtype,) * 3] * 8
        est = net._estimator
        assert np.isfinite([v for _, v in est.loss_log]).all()
        assert {t.dtype for t in tree_leaves(net.params)
                + tree_leaves(est._opt_state.mu)
                + tree_leaves(est._opt_state.nu)} == {torch.float32}


def _bert_base_leaf_shapes():
    """The BERT-base classifier's parameter shapes: 12 blocks of hidden 768
    and intermediate 3072, the embeddings, the pooler and a Dense(2)."""
    block = [(768, 2304), (2304,), (768, 768), (768,), (768,), (768,),
             (768, 3072), (3072,), (3072, 768), (768,), (768,), (768,)]
    return (block * 12 + [(30522, 768), (512, 768), (2, 768), (768,),
                          (768,), (768, 768), (768,), (768, 2), (2,)])


@pytest.mark.cuda
@pytest.mark.parametrize("tree", ["bert_base", "odd"])
def test_adam_one_launch_bit_identical(tree, cuda_device):
    """fused_update over a whole tree: one launch, every kernel leaf's
    outputs equal to the plain version's bit for bit, small and non-f32
    leaves on the plain formula."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)

    def rand(shape, scale, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                * scale).to(dtype)

    if tree == "bert_base":
        shapes = _bert_base_leaf_shapes()
        leaves = [(rand(sh, 1e-3), rand(sh, 1e-4), rand(sh, 1e-8).abs())
                  for sh in shapes]
    else:
        sizes = [128, 129, 4099, 768 * 3072 + 1, 127, 1000]
        leaves = [(rand(n, 1.0), rand(n, 0.1), rand(n, 0.01).abs())
                  for n in sizes]
        # unaligned views: one element into a larger buffer
        big = [rand(4100, s).abs() if i == 2 else rand(4100, s)
               for i, s in enumerate((1.0, 0.1, 0.01))]
        leaves.append(tuple(t[1:] for t in big))
        leaves.append(tuple(rand(300, s, torch.bfloat16).abs()
                            for s in (1.0, 0.1, 0.01)))
    scalars = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 1 - 0.9 ** 3,
                            1 - 0.999 ** 3], dtype=torch.float32,
                           device=cuda_device)
    kernel = [g.dtype == torch.float32 and g.numel() >= 128
              for g, _, _ in leaves]
    before = tadam.launch_count, tadam.leaf_count, tadam.plain_count
    upd, mu, nu = tadam.fused_update(*zip(*leaves), scalars)
    torch.cuda.synchronize()
    assert (tadam.launch_count, tadam.leaf_count, tadam.plain_count) == \
        (before[0] + 1, before[1] + sum(kernel), before[2])
    for i, (g, m, n) in enumerate(leaves):
        want = tadam.adam_leaf_reference(g, m, n, scalars)
        for got_t, want_t in zip((upd[i], mu[i], nu[i]), want):
            assert got_t.shape == g.shape
            if kernel[i]:
                assert torch.equal(got_t, want_t), i
    # kernel leaves are views into three flat buffers that never overlap
    spans = sorted((t.data_ptr(), t.data_ptr() + 4 * t.numel())
                   for i, t in enumerate(upd) if kernel[i])
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(s[0] % 16 == 0 for s in spans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(8, 2), (4096, 30522)],
                         ids=["head", "lm_head"])
def test_softmax_xent_kernels_match_plain(shape, dtype, cuda_device):
    b, v = shape
    gen = np.random.default_rng(b)
    x = torch.from_numpy((gen.normal(size=shape) * 3).astype(np.float32)
                         ).to(cuda_device, dtype)
    labels = torch.from_numpy(gen.integers(0, v, b)).to(cuda_device)
    g = torch.from_numpy(gen.normal(size=b).astype(np.float32)
                         ).to(cuda_device)
    before = txent.fwd_launch_count, txent.bwd_launch_count
    loss, lse = txent._fwd_cuda(x, labels)
    dx = txent._bwd_cuda(x, labels, lse, g)
    torch.cuda.synchronize()
    assert (txent.fwd_launch_count, txent.bwd_launch_count) == \
        (before[0] + 1, before[1] + 1)
    w_loss, w_lse = txent.xent_reference(x, labels)
    torch.testing.assert_close(loss, w_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-5, atol=1e-5)
    w_dx = txent.xent_bwd_reference(x, labels, w_lse, g)
    assert dx.dtype == dtype
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
           torch.float16: 2e-3}[dtype]
    torch.testing.assert_close(dx.float(), w_dx.float(), rtol=tol, atol=tol)


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a wrapper sees for a
    CUDA tensor, on a machine that has none."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_cuda_tensors_never_take_the_plain_versions(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the kernels run instead")
    plain = []
    for mod, name in ((tadam, "adam_leaf_reference"),
                      (txent, "xent_reference"),
                      (txent, "xent_bwd_reference"),
                      (tfa, "attention_bwd_reference")):
        monkeypatch.setattr(mod, name, lambda *a, **k: plain.append(1))
    x = _OnCuda(torch.zeros(128))
    with pytest.raises(Exception):
        tadam.adam_leaf(x, x, x, _OnCuda(torch.zeros(6)))
    with pytest.raises(Exception):
        txent._fwd_cuda(_OnCuda(torch.zeros(8, 2)),
                        _OnCuda(torch.zeros(8, dtype=torch.int64)))
    q = _OnCuda(torch.zeros(1, 2, 256, 64))
    with pytest.raises(Exception):
        tfa._flash_bwd_cuda(q, q, q, q, q, None, None, False, 0.125, None)
    assert plain == []


def test_chunked_backward_inputs_suit_tensor_copies():
    """The chunked backward (head dims above 128) reads q, k, v and dO with
    tensor copies: a split-heads view of a fused projection suits them as
    it is; a view whose base or row stride is not a multiple of 16 bytes
    does not, and the wrapper hands the kernels a copy instead."""
    x = torch.zeros(2, 8, 3 * 4 * 192)
    q = x.reshape(2, 8, 3, 4, 192)[:, :, 0].transpose(1, 2)
    assert q.shape == (2, 4, 8, 192) and tfa._tma_ready(q)
    odd = torch.zeros(2, 4, 8, 193)[..., 1:]
    assert not tfa._tma_ready(odd)
    assert tfa._tma_ready(odd.clone(memory_format=torch.contiguous_format))
    assert not tfa._tma_ready(
        torch.zeros(2, 4, 8, 196, dtype=torch.bfloat16)[..., 4:])


@pytest.mark.parametrize("d,dtype,backward,copied", [
    (64, torch.bfloat16, True, True),
    (128, torch.float16, True, True),
    (64, torch.float32, True, False),
    (64, torch.bfloat16, False, False),
    (96, torch.float16, True, False),
], ids=["d64-bf16-bwd", "d128-f16-bwd", "d64-f32-bwd", "d64-bf16-fwd",
        "d96-f16-bwd"])
def test_bwd16_inputs_suit_tensor_copies(d, dtype, backward, copied):
    """The 16-bit backward at head dims 64 and 128 reads q, k, v and dO with
    tensor copies: the wrapper hands it a copy of a view whose base or row
    stride is not a multiple of 16 bytes, and a split-heads view of a fused
    projection as it is.  The f32 backward, the 16-bit forward at those
    head dims and the CUDA-core bodies read rows through their strides and
    get the views."""
    b, h, n = 2, 3, 8
    x = torch.zeros(b, n, 3 * h * d, dtype=dtype)
    fused = [t.reshape(b, n, h, d).transpose(1, 2)
             for t in torch.chunk(x, 3, dim=-1)]
    odd = torch.zeros(b, h, n, d + 1, dtype=dtype)[..., 1:]
    got = tfa._kernel_inputs(d, odd, *fused, backward=backward)
    assert (got[0].data_ptr() != odd.data_ptr()) == copied
    assert tfa._tma_ready(got[0]) == (copied or tfa._tma_ready(odd))
    assert [t.data_ptr() for t in got[1:]] == [t.data_ptr() for t in fused]


@pytest.mark.parametrize("d,dtype,layout,copied", [
    (192, torch.float32, "fused", False),
    (384, torch.float32, "misaligned", True),
    (256, torch.bfloat16, "misaligned", True),
    (96, torch.float32, "misaligned", False),
], ids=["d192-fused", "d384-misaligned", "d256-bf16-misaligned",
        "d96-cuda-cores"])
def test_chunked_forward_inputs_suit_tensor_copies(d, dtype, layout, copied,
                                                   monkeypatch):
    """The forward wrapper hands the chunked kernel (head dims above 128
    that are multiples of 64) only inputs that tensor copies can read: a
    split-heads view of a fused projection as it is, a view whose base or
    row stride is not a multiple of 16 bytes as a copy.  The CUDA-core body
    (other head dims) reads rows element by element and gets the view."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the kernels run instead")
    b, h, n = 2, 3, 8
    x = torch.zeros(b, n, 3 * h * d, dtype=dtype)
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2)
               for t in torch.chunk(x, 3, dim=-1))
    if layout == "misaligned":
        q = torch.zeros(b, h, n, d + 1, dtype=dtype)[..., 1:]
    handed = {}

    class Lib:
        def zoo_flash_attention_fwd(self, *args):
            handed["ptrs"] = args[2:5]
            handed["strides"] = (args[15:18], args[18:21], args[21:24])
            return 0

    monkeypatch.setattr(tfa, "_library", lambda name: Lib())
    monkeypatch.setattr(tfa, "_stream", lambda device: 0)
    before = tfa.launch_count
    out, _, _ = tfa._flash_cuda(*(_OnCuda(t) for t in (q, k, v)), False,
                                0.125, None)
    assert tfa.launch_count == before + 1 and out.shape == (b, h, n, d)
    es = q.element_size()
    ok = [p % 16 == 0 and all(s * es % 16 == 0 for s in st)
          for p, st in zip(handed["ptrs"], handed["strides"])]
    assert ok == ([True] * 3 if d % 64 == 0 else [False, True, True])
    assert (handed["ptrs"][0] != q.data_ptr()) == copied
    assert handed["ptrs"][1:] == (k.data_ptr(), v.data_ptr())


def test_other_devices_raise():
    meta = torch.zeros(256, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tadam.adam_leaf(meta, meta, meta, torch.zeros(6, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        txent.softmax_xent(torch.zeros(8, 2, device="meta"),
                           torch.zeros(8, dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("mod", [tfa, tadam, txent],
                         ids=["flash_attention", "fused_adam",
                              "fused_softmax_xent"])
def test_wrappers_have_no_try_fallback(mod):
    tree = ast.parse(inspect.getsource(mod))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_adam_routes_by_the_reference_gate(monkeypatch):
    """f32 leaves of >= 128 elements go to adam_leaf (the kernel on a GPU);
    smaller or non-f32 leaves take the plain formula."""
    seen = []
    real = tadam.adam_leaf
    monkeypatch.setattr(tadam, "adam_leaf",
                        lambda g, *a: seen.append(g.numel()) or real(g, *a))
    leaves = [torch.ones(128), torch.ones(127), torch.ones(2, 64),
              torch.ones(300, dtype=torch.float64)]
    scalars = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.1, 0.001])
    upd, mu, nu = tadam.fused_update(
        leaves, [torch.zeros_like(t) for t in leaves],
        [torch.zeros_like(t) for t in leaves], scalars)
    assert seen == [128, 128]
    assert [u.shape for u in upd] == [t.shape for t in leaves]
