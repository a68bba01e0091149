"""The port's training kernels and their dispatch, without JAX.

The ``cuda``-marked tests hold each CUDA kernel of the training slice
against its plain version on a GPU and skip where none is visible:

- the flash-attention forward with dropout and (m, l) statistics, and the
  flash-attention backward (dq, dk, dv, bias-gradient partials): head dims
  64 and 128, padding, per-head and full biases, causal with lq < lk and
  lq > lk, dropout 0.1, a fully masked row; f32 within 2e-4 of the plain
  version (relative to the largest value when it exceeds 1: both sum
  512-long products in f32, in different orders), bf16 inputs within
  2e-2 of the plain version run in f32;
- the fused Adam update over leaves of odd sizes, within 1e-6 relative
  (the kernel rounds each operation as the plain formula does);
- the fused softmax cross-entropy forward and backward at the classifier
  head (8, 2) and an LM head (4096, 30522), within 1e-5 (f32 sums over the
  vocab in different orders).

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _attn_inputs(b, h, lq, lk, d, bias_kind, device, seed=0):
    gen = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (gen.normal(size=shape) * scale).astype(np.float32)).to(device)

    # q/k/v as split_heads views (non-contiguous rows), as the model
    # hands them over
    q = t((b, lq, h, d)).transpose(1, 2)
    k = t((b, lk, h, d)).transpose(1, 2)
    v = t((b, lk, h, d)).transpose(1, 2)
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
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
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
    if bias_kind == "padding":
        # the fully masked batch row: zero output, zero gradients
        for t in (out, dq, dk, dv):
            assert t[-1].float().abs().max().item() == 0.0


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
    full = torch.zeros(2, 1, 256, 256, device=cuda_device,
                       requires_grad=True)
    out = tfa.flash_attention(q, k, v, bias=full)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.backward(g)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
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
    tol = 1e-5 if dtype == torch.float32 else 1e-2
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
