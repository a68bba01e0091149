"""int8 x int8 -> int32 convolution: the CUDA kernel's wrapper and its plain
version.

No Pallas kernel is its counterpart: the reference's calibrated conv
(``_int8_conv``, ``analytics_zoo_tpu/pipeline/inference/quantize.py``) is a
``lax.conv_general_dilated`` with ``preferred_element_type=int32``, and
PyTorch has no int8 convolution on CUDA, so ``csrc/int8_conv.cu`` computes
it on the H100's integer tensor cores.  It takes an unpadded channels-last
int8 activation x (N, ..spatial.., Cin) of rank 1, 2 or 3, the kernel as a
(Cout, K) int8 copy (:func:`conv_weight_t`; K = taps x Cin, in the HWIO
kernel's order), the kernel size, strides, dilation and (before, after)
pads per spatial dim, and returns the exact int32 sums (N, ..out.., Cout).
A calibrated Dense is the rank-1 case with one tap (x (M, 1, K)).

The sums are exact for operands in [-127, 127] (``_quantize_act`` and the
weight quantization clamp to it) while K x 127^2 stays below 2^31: the
wrapper raises past ``MAX_K``, where the reference's int32 would wrap.

:func:`int8_conv` launches the kernel for a CUDA tensor and takes
:func:`int8_conv_reference` for a CPU tensor; nothing falls back from one to
the other.  ``launch_count`` counts the kernel launches, ``plain_count`` the
calls that took the plain version.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.nn.functional as F

launch_count = 0
plain_count = 0

_KERNEL = "int8_conv"
_INT32_MAX = 2 ** 31 - 1
# the largest K whose sums of products in [-127, 127]^2 fit in int32
MAX_K = _INT32_MAX // (127 * 127)


def conv_weight_t(values):
    """The (Cout, K) copy of an int8 kernel (..taps.., Cin, Cout) (a Dense
    kernel (K, Cout) is one tap) that the kernel reads: K contiguous for
    each output channel, in the kernel's own (taps, Cin) order."""
    return values.reshape(-1, values.shape[-1]).t().contiguous()


def out_size(n: int, k: int, stride: int, dilation: int, lo: int,
             hi: int) -> int:
    """One output dim of a convolution over ``n`` padded by (lo, hi)."""
    return (n + lo + hi - (k - 1) * dilation - 1) // stride + 1


def _geometry(x, w_t, kernel_size, strides, dilation, pads):
    """(rank, out spatial dims) after checking the arguments agree."""
    r = x.dim() - 2
    if r not in (1, 2, 3):
        raise ValueError(f"int8_conv takes rank 1, 2 or 3 (x of 3 to 5 "
                         f"dims), got x {tuple(x.shape)}")
    for name, v in (("kernel_size", kernel_size), ("strides", strides),
                    ("dilation", dilation), ("pads", pads)):
        if len(v) != r:
            raise ValueError(f"int8_conv: {name} {v} is not of rank {r}")
    if min(kernel_size) < 1 or min(strides) < 1 or min(dilation) < 1 \
            or min(p for lo_hi in pads for p in lo_hi) < 0:
        raise ValueError(f"int8_conv: kernel {kernel_size}, strides "
                         f"{strides}, dilation {dilation}, pads {pads}")
    k = math.prod(kernel_size) * x.shape[-1]
    if w_t.dim() != 2 or w_t.shape[1] != k:
        raise ValueError(f"int8_conv takes the kernel as (Cout, {k}), got "
                         f"{tuple(w_t.shape)}")
    out = tuple(out_size(int(n), kk, s, d, lo, hi) for n, kk, s, d, (lo, hi)
                in zip(x.shape[1:-1], kernel_size, strides, dilation, pads))
    if min(out) < 1:
        raise ValueError(f"int8_conv: input {tuple(x.shape)} gives output "
                         f"dims {out}")
    return r, out


def int8_conv_reference(x, w_t, kernel_size, strides, dilation, pads):
    """Plain version: the zero-padded input in int32, and for each tap its
    strided slice (N, ..out.., Cin) times that tap's (Cin, Cout) slice of
    the kernel (int32 matmul), summed over the taps.  Exact for every rank;
    CPU tensors only (CUDA has no int32 matmul)."""
    r, out = _geometry(x, w_t, kernel_size, strides, dilation, pads)
    cin, cout = x.shape[-1], w_t.shape[0]
    flat = [0, 0] + [p for lo_hi in reversed(pads) for p in lo_hi]
    xp = F.pad(x.to(torch.int32), flat)
    acc = torch.zeros((x.shape[0],) + out + (cout,), dtype=torch.int32)
    for t, tap in enumerate(itertools.product(*map(range, kernel_size))):
        window = tuple(slice(i * d, i * d + (o - 1) * s + 1, s)
                       for i, d, o, s in zip(tap, dilation, out, strides))
        xs = xp[(slice(None),) + window]
        wk = w_t[:, t * cin:(t + 1) * cin].to(torch.int32)
        acc += (xs.reshape(-1, cin) @ wk.t()).reshape(acc.shape)
    return acc


def int8_conv(x, w_t, kernel_size, strides, dilation, pads):
    """The exact int32 sums of the convolution of the int8 channels-last
    ``x`` (N, ..spatial.., Cin) with the int8 kernel copy ``w_t`` (Cout,
    K), at ``strides`` and ``dilation``, x padded by ``pads`` ((before,
    after) per spatial dim) with zeros: (N, ..out.., Cout) int32."""
    global plain_count
    if x.device.type == "cpu":
        plain_count += 1
        return int8_conv_reference(x, w_t, kernel_size, strides, dilation,
                                   pads)
    return _int8_conv_cuda(x, w_t, kernel_size, strides, dilation, pads)


def _check(x, w_t):
    """Raise on what the kernel does not take: a device other than CUDA,
    operands that are not int8, on other devices or not contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for device {x.device}")
    for name, t in (("x", x), ("the kernel", w_t)):
        if t.dtype != torch.int8:
            raise TypeError(f"int8_conv kernel takes int8 {name}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"int8_conv: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_conv kernel takes a contiguous {name}")


def _int8_conv_cuda(x, w_t, kernel_size, strides, dilation, pads):
    global launch_count
    _check(x, w_t)
    r, out = _geometry(x, w_t, kernel_size, strides, dilation, pads)
    k = w_t.shape[1]
    if k > MAX_K:
        raise ValueError(f"int8_conv: K = {k} taps x channels could wrap "
                         f"the int32 sums (at most {MAX_K})")
    m = x.shape[0] * math.prod(out)
    if max(m, x.numel(), w_t.shape[0]) > _INT32_MAX:
        raise ValueError(f"int8_conv: sizes of x {tuple(x.shape)} exceed "
                         "the kernel's 32-bit rows")
    ones = (1,) * (3 - r)
    spatial = ones + tuple(x.shape[1:-1])
    geo = (ctypes.c_int * 21)(
        x.shape[0], *spatial, x.shape[-1], *(ones + out), w_t.shape[0],
        *(ones + tuple(kernel_size)), *(ones + tuple(strides)),
        *(ones + tuple(dilation)),
        *((0,) * (3 - r) + tuple(lo for lo, _ in pads)))
    res = torch.empty((x.shape[0],) + out + (w_t.shape[0],),
                      dtype=torch.int32, device=x.device)
    rc = _library().zoo_int8_conv(
        x.data_ptr(), w_t.data_ptr(), res.data_ptr(), geo,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError {rc}")
    launch_count += 1
    return res


_LIB = None


def _library():
    """The kernel library, built at first use, with its C signature."""
    global _LIB
    if _LIB is None:
        from analytics_zoo_tpu_torch.ops.cuda.build import load

        lib = load(_KERNEL)
        lib.zoo_int8_conv.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.zoo_int8_conv.restype = ctypes.c_int
        _LIB = lib
    return _LIB
