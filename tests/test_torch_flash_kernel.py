"""The port's CUDA flash-attention kernel and its dispatch, without JAX.

The ``cuda``-marked tests hold the kernel against its plain version on a
GPU (f32 within 1e-4; bf16 inputs within 2e-2 and f16 inputs within 4e-3
of the plain version run in f32: f16 rounds P and the output to 11
significant bits, a step of at most 2**-9 for outputs below 4, against
bf16's 8; the tensor-core bodies at head dims 64 and 128, f32 as 3xTF32,
bf16 and f16 also with dropout and the (m, l) statistics, and the chunked
tensor-core body at 192 and 256) and skip where none is visible.  A body
that read f16 bits as bf16 (or issued a bf16 product on them) would miss
the f16 tolerance by orders of magnitude.  This file imports
nothing from the JAX package, so on a machine with a GPU and no JAX it
runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_flash_kernel.py

The other tests check on the CPU that the wrapper never falls back: a
tensor on a CUDA device goes to the kernel or raises.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops.cuda import flash_attention as tfa

# (b, h, lq, lk, d, causal, bias kind)
CASES = [
    (8, 12, 512, 512, 64, False, "padding"),   # BERT-base serving shape
    (2, 4, 448, 500, 64, True, None),          # end-aligned, ragged lk
    (2, 2, 300, 173, 128, True, "padding"),    # lq > lk: rows see no key
    (1, 2, 256, 301, 192, False, "full"),
    (2, 2, 130, 200, 256, False, "heads"),
]


F16_TOL = 4e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _inputs(b, h, lq, lk, d, bias_kind, device, seed=0):
    gen = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (gen.normal(size=shape) * scale).astype(np.float32)).to(device)

    # q/k/v as split_heads views (non-contiguous rows), as the model
    # hands them over
    q = t((b, lq, h, d)).transpose(1, 2)
    k = t((b, lk, h, d)).transpose(1, 2)
    v = t((b, lk, h, d)).transpose(1, 2)
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
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, F16_TOL)],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_cuda_kernel_matches_plain(case, dtype, tol, cuda_device):
    b, h, lq, lk, d, causal, bias_kind = case
    q, k, v, bias = _inputs(b, h, lq, lk, d, bias_kind, cuda_device)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = tfa.launch_count
    got = tfa.flash_attention(q, k, v, causal, None, bias=bias)
    torch.cuda.synchronize()
    assert tfa.launch_count == before + 1
    assert got.dtype == dtype and got.shape == (b, h, lq, d)
    want = tfa.attention_reference(q.float(), k.float(), v.float(), causal,
                                   1.0 / np.sqrt(d), bias=bias)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= tol
    if bias_kind == "padding":
        assert got[-1].float().abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, F16_TOL)],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_kernel_bf16_dropout_stats_match_plain(d, dtype, tol,
                                                    cuda_device):
    """The 16-bit tensor-core route with dropout 0.1 and the (m, l)
    statistics: the dropout mask is the hash's, bit for bit, so out, m and
    l agree with the plain version run in f32 within the input type's
    tolerance."""
    q, k, v, bias = _inputs(4, 3, 320, 320, d, "padding", cuda_device)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    seed, scale = (0x2545F491, 0x9E3779B9), 1.0 / np.sqrt(d)
    before = tfa.launch_count
    got, m, l = tfa._flash_cuda(q, k, v, False, scale, bias, 0.1, seed,
                                stats=True)
    torch.cuda.synchronize()
    assert tfa.launch_count == before + 1
    want, w_m, w_l = tfa.attention_reference(
        q.float(), k.float(), v.float(), False, scale, bias, 0.1, seed, True)
    assert got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= tol
    assert (m - w_m).abs().max().item() <= tol
    assert ((l - w_l).abs() / w_l.abs().clamp_min(1.0)).max().item() <= tol
    assert got[-1].float().abs().max().item() == 0.0


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the wrapper sees for
    a CUDA tensor, on a machine that has none."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    plain = []
    monkeypatch.setattr(tfa, "attention_reference",
                        lambda *a, **k: plain.append(1))
    q = _OnCuda(torch.zeros(1, 2, 256, 64))
    before = tfa.launch_count
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the kernel runs instead")
    with pytest.raises(Exception):
        tfa.flash_attention(q, q, q)
    assert plain == [] and tfa.launch_count == before


def test_other_devices_raise():
    q = torch.zeros(1, 2, 256, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention(q, q, q)


def test_wrapper_has_no_try_fallback():
    tree = ast.parse(inspect.getsource(tfa))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_masks_like_the_kernel(causal):
    """A fully masked row is zeros; with causal lq > lk the rows before the
    end-aligned diagonal are zeros; every other row is a softmax average."""
    q, k, v, bias = _inputs(2, 2, 300, 173, 64, "padding", "cpu")
    out = tfa.attention_reference(q, k, v, causal, 0.125, bias=bias)
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    if causal:
        assert torch.equal(out[:, :, :127], torch.zeros_like(out[:, :, :127]))
    assert torch.isfinite(out).all()
