"""Fused Adam: the CUDA kernel's wrapper, its plain version, and the tree
update that routes leaves to it.

Counterpart of ``analytics_zoo_tpu/ops/pallas/fused_adam.py``.
``csrc/fused_adam.cu`` replaces the TPU kernel ``_adam_kernel`` (launched
per leaf by ``_adam_leaf_pallas``): one read of (g, mu, nu) and one write
of (upd, mu', nu') per parameter, with the scalars (lr, b1, b2, eps, bc1,
bc2) in a device array.

:func:`fused_update` is the reference's ``_fused_update``: the scalars are
computed once per step on the device (lr at the pre-increment count,
bc = 1 - beta^t at the incremented one), f32 leaves of at least 128
elements go through :func:`adam_leaf` and every other leaf takes the same
formula in plain PyTorch (the reference's shape gate, not a fallback).
:func:`adam_leaf` launches the kernel for a CUDA tensor and takes
:func:`adam_leaf_reference` for a CPU tensor.  ``launch_count`` counts the
kernel launches (one per leaf, as on the TPU), ``plain_count`` the leaves
that took the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

launch_count = 0
plain_count = 0         # leaves that took the plain version (CPU)

_KERNEL = "fused_adam"
# the reference's gate: leaves smaller than one (8, 128) tile row
# (``g.size >= _LANES``) take the plain formula
MIN_KERNEL_LEAF = 128
_INT32_MAX = 2 ** 31 - 1


def adam_leaf_reference(g, mu, nu, scalars):
    """Plain version with the kernel's formula and rounding order:
    (upd, mu', nu')."""
    lr, b1, b2, eps, bc1, bc2 = scalars.unbind(0)
    g = g.float()
    mu2 = b1 * mu + (1.0 - b1) * g
    nu2 = b2 * nu + (1.0 - b2) * g * g
    upd = -lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
    return upd, mu2, nu2


def adam_leaf(g, mu, nu, scalars):
    """One leaf's update: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    global plain_count
    if g.device.type == "cpu":
        plain_count += 1
        return adam_leaf_reference(g, mu, nu, scalars)
    return _adam_cuda(g, mu, nu, scalars)


_POWERS: dict = {}


def _int_pow(bases, n):
    """``f32(base) ** n`` for each base, for a 0-d int tensor ``n`` >= 0,
    rounded as JAX rounds it: JAX raises an f32 to an int32 power by
    binary exponentiation (r *= x for each set bit of n, x *= x after each
    bit, f32 rounding each time).  Near 1 - beta^t the cancellation
    magnifies one ulp of beta^t a few hundred times, so the bias correction
    follows the reference's rounding, not the correctly rounded power.
    The squares depend on the bases alone and are made once on the host;
    the bits of n are read on its device, so no step waits on the host."""
    key = (tuple(bases), str(n.device))
    squares = _POWERS.get(key)
    if squares is None:
        rows = []
        for base in bases:
            x, row = np.float32(base), []
            for _ in range(32):
                row.append(x)
                x = np.float32(x * x)
            rows.append(row)
        squares = torch.tensor(np.array(rows, np.float32), device=n.device)
        _POWERS[key] = squares
    bits = (n.to(torch.int64) >> torch.arange(32, device=n.device)) & 1
    factors = torch.where(bits.bool(), squares, 1.0)
    r = factors[:, 0]
    for i in range(1, 32):  # sequential: the reference's rounding order
        r = r * factors[:, i]
    return r


def adam_scalars(count, lr_fn, b1, b2, eps):
    """(scalars, count_inc): the (6,) f32 device array (lr, b1, b2, eps,
    bc1, bc2) and the incremented step count (optax's saturating
    ``safe_int32_increment``), all computed on ``count``'s device."""
    count_inc = torch.where(count < _INT32_MAX, count + 1, count)
    lr = lr_fn(count)
    if not torch.is_tensor(lr):  # a constant: made on the device once
        lr = _const((lr,), count.device)
    bc = 1.0 - _int_pow((b1, b2), count_inc)
    return torch.cat([lr.to(torch.float32).reshape(1),
                      _const((b1, b2, eps), count.device), bc]), count_inc


_CONSTS: dict = {}


def _const(values, device):
    """An f32 device tensor of ``values``, copied to the device once: a
    copy from pageable host memory would wait for the stream every step."""
    key = (tuple(values), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=torch.float32,
                                        device=device)
    return t


def fused_update(grads, mu, nu, scalars, kernel=True):
    """Lists of leaves in, lists of (updates, mu', nu') out; ``kernel=False``
    (the plan's ``"xla"`` pick) gives every leaf the plain formula."""
    out = []
    for g, m, n in zip(grads, mu, nu):
        if kernel and g.dtype == torch.float32 \
                and g.numel() >= MIN_KERNEL_LEAF:
            out.append(adam_leaf(g, m, n, scalars))
        else:
            out.append(adam_leaf_reference(g, m, n, scalars))
    return ([t[0] for t in out], [t[1] for t in out], [t[2] for t in out])


def _adam_cuda(g, mu, nu, scalars):
    global launch_count
    if g.device.type != "cuda":
        raise ValueError(f"fused_adam: no kernel for device {g.device}")
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32 or t.device != g.device \
                or t.shape != g.shape:
            raise TypeError(f"fused_adam kernel takes f32 g/mu/nu of one "
                            f"shape on one device; {name} is {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    if scalars.dtype != torch.float32 or scalars.shape != (6,) \
            or scalars.device != g.device:
        raise TypeError("fused_adam kernel takes a (6,) f32 scalar array on "
                        "the leaf's device")
    g, mu, nu, scalars = (t.contiguous() for t in (g, mu, nu, scalars))
    upd, mu2, nu2 = (torch.empty_like(g) for _ in range(3))
    rc = _library().zoo_fused_adam(
        g.data_ptr(), mu.data_ptr(), nu.data_ptr(), scalars.data_ptr(),
        upd.data_ptr(), mu2.data_ptr(), nu2.data_ptr(), g.numel(),
        torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: cudaError {rc}")
    launch_count += 1
    return upd, mu2, nu2


_LIB = None


def _library():
    """The kernel library, built at first use, with its C signature."""
    global _LIB
    if _LIB is None:
        from analytics_zoo_tpu_torch.ops.cuda.build import load

        lib = load(_KERNEL)
        lib.zoo_fused_adam.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_longlong, ctypes.c_void_p])
        lib.zoo_fused_adam.restype = ctypes.c_int
        _LIB = lib
    return _LIB
