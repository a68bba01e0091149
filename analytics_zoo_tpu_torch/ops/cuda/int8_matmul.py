"""Weight-only int8 matmul: the CUDA kernel's wrapper and its plain version.

Counterpart of ``analytics_zoo_tpu/ops/pallas/int8_matmul.py``.
``csrc/int8_matmul.cu`` replaces the TPU kernel ``_mm_kernel`` (launched by
``_matmul_pallas``): ``x (M, K) @ W (K, N)`` with W int8 through device and
shared memory, converted to f32 in registers, the f32 sum multiplied by the
per-output-channel scale (N,) once at the end and cast to x's dtype.  The
kernel masks ragged edges itself; nothing is padded in device memory.

:func:`int8_matmul` launches the kernel for a CUDA tensor and takes
:func:`_reference` for a CPU tensor; nothing falls back from one to the
other.  ``launch_count`` counts the kernel launches, ``plain_count`` the
calls that took the plain version.
"""

from __future__ import annotations

import ctypes

import torch

launch_count = 0
plain_count = 0

_KERNEL = "int8_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1


def _reference(x, values, scale):
    """Plain version (the reference's ``_reference``): the f32 product of x
    and the int8 values, times the scale per column, in x's dtype."""
    out = x.float() @ values.float()
    return (out * scale.float()[None, :]).to(x.dtype)


def int8_matmul(x, values, scale):
    """``x @ dequantize(values, scale)`` with the weight kept int8: x (M, K)
    f32 or bf16, values (K, N) int8, scale (N,) f32 per output channel;
    returns (M, N) in x's dtype."""
    global plain_count
    if x.device.type == "cpu":
        plain_count += 1
        return _reference(x, values, scale)
    return _int8_matmul_cuda(x, values, scale)


def _int8_matmul_cuda(x, values, scale):
    global launch_count
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise TypeError(f"int8_matmul kernel takes a 2-D f32 or bf16 x, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if values.dtype != torch.int8 or values.dim() != 2 \
            or values.shape[0] != x.shape[1]:
        raise TypeError(f"int8_matmul kernel takes int8 values (K, N) with "
                        f"K = {x.shape[1]}, got {values.dtype} "
                        f"{tuple(values.shape)}")
    if scale.dtype != torch.float32 or scale.shape != values.shape[1:]:
        raise TypeError(f"int8_matmul kernel takes an f32 scale of shape "
                        f"({values.shape[1]},), got {scale.dtype} "
                        f"{tuple(scale.shape)}")
    for name, t in (("values", values), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul kernel takes a contiguous {name}")
    if not x.is_contiguous():
        raise ValueError("int8_matmul kernel takes a contiguous x")
    (m, k), n = x.shape, values.shape[1]
    if max(m, k, n) > _INT32_MAX:
        raise ValueError(f"int8_matmul: dimensions ({m}, {k}, {n}) exceed "
                         "the kernel's 32-bit sizes")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    rc = _library().zoo_int8_matmul(
        x.data_ptr(), values.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, n, k, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {rc}")
    launch_count += 1
    return out


_LIB = None


def _library():
    """The kernel library, built at first use, with its C signature."""
    global _LIB
    if _LIB is None:
        from analytics_zoo_tpu_torch.ops.cuda.build import load

        lib = load(_KERNEL)
        lib.zoo_int8_matmul.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p])
        lib.zoo_int8_matmul.restype = ctypes.c_int
        _LIB = lib
    return _LIB
