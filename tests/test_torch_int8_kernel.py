"""The int8 matmul kernel and its wrapper, without JAX.

The ``cuda``-marked tests hold ``csrc/int8_matmul.cu`` against its plain
version on a GPU and skip where none is visible: ragged M, N and K, the
BERT-base head (8, 768, 2) and pooler, K = 3072 and the QKV shape of one
8 x 512 micro-batch, each with f32 x (relative L2 <= 1e-5: f32 sums in
another order) and bf16 x (<= 1e-2 against the plain version in f32: the
output's bf16 rounding).  This file imports nothing from the JAX package,
so on a machine with a GPU and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_int8_kernel.py

The other tests check on the CPU that the wrapper never falls back: a
tensor on a CUDA device goes to the kernel or raises, and what the kernel
does not take raises before any launch.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as tim
from analytics_zoo_tpu_torch.parallel import (
    compile_step,
    int8_serving,
    with_kernels,
)
from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
    QuantizedTensor,
    quantized_matmul,
)

F32_TOL = 1e-5
BF16_TOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _inputs(m, k, n, device, seed=0):
    gen = np.random.default_rng(seed)
    x = torch.from_numpy(gen.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy(gen.integers(-127, 128, size=(k, n)).astype(np.int8))
    s = torch.from_numpy(gen.uniform(0.005, 0.02, size=(n,)).astype(
        np.float32))
    return x.to(device), w.to(device), s.to(device)


def _rel(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(13, 200, 70), (1, 33, 1), (8, 768, 2),
                                   (8, 768, 768), (130, 3072, 131),
                                   (4096, 768, 2304)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(shape, dtype, tol, cuda_device):
    x, w, s = _inputs(*shape, cuda_device)
    x = x.to(dtype)
    before = tim.launch_count
    got = tim.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert tim.launch_count == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], shape[2])
    assert torch.isfinite(got.float()).all()
    assert _rel(got, tim._reference(x.float(), w, s)) <= tol


@pytest.mark.cuda
def test_quantized_matmul_launches_under_the_kernel_plan(cuda_device):
    x, w, s = _inputs(64, 256, 96, cuda_device, seed=1)
    qt = QuantizedTensor(w, s.reshape(1, -1), 1)
    before = tim.launch_count
    out = compile_step(lambda: quantized_matmul(x, qt),
                       with_kernels(int8_serving()))()
    xla = compile_step(lambda: quantized_matmul(x, qt), with_kernels(
        int8_serving(), (("serving.int8_matmul", "xla"),)))()
    torch.cuda.synchronize()
    assert tim.launch_count == before + 1
    assert _rel(out, xla) <= F32_TOL


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what the wrapper sees for a
    CUDA tensor, on a machine that has none."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the kernel runs instead")
    plain = []
    monkeypatch.setattr(tim, "_reference", lambda *a: plain.append(1))
    x, w, s = _inputs(8, 64, 16, "cpu")
    with pytest.raises(Exception):
        tim.int8_matmul(_OnCuda(x), _OnCuda(w), _OnCuda(s))
    assert plain == []


@pytest.mark.parametrize("case,error", [
    ("x_dtype", TypeError), ("x_rank", TypeError), ("w_dtype", TypeError),
    ("k_mismatch", TypeError), ("scale_shape", TypeError),
    ("scale_dtype", TypeError), ("x_strided", ValueError),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, error):
    """Checked before the library is loaded, so no launch happens."""
    x, w, s = _inputs(8, 64, 16, "cpu")
    if case == "x_dtype":
        x = x.double()
    elif case == "x_rank":
        x = x[None]
    elif case == "w_dtype":
        w = w.to(torch.int16)
    elif case == "k_mismatch":
        w = w[:32]
    elif case == "scale_shape":
        s = s[:8]
    elif case == "scale_dtype":
        s = s.double()
    elif case == "x_strided":
        x = torch.zeros(64, 8).t()
    before = tim.launch_count
    with pytest.raises(error):
        tim._int8_matmul_cuda(_OnCuda(x), _OnCuda(w), _OnCuda(s))
    assert tim.launch_count == before


def test_other_devices_raise():
    meta = torch.zeros(8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tim.int8_matmul(meta, torch.zeros(64, 16, dtype=torch.int8,
                                          device="meta"),
                        torch.zeros(16, device="meta"))


def test_cpu_takes_the_plain_version_and_counts_it():
    x, w, s = _inputs(13, 200, 70, "cpu")
    before = tim.launch_count, tim.plain_count
    out = tim.int8_matmul(x, w, s)
    assert (tim.launch_count, tim.plain_count) == (before[0], before[1] + 1)
    want = (x.double() @ w.double()) * s.double()
    assert _rel(out, want) <= F32_TOL


def test_wrapper_has_no_try_fallback():
    tree = ast.parse(inspect.getsource(tim))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
