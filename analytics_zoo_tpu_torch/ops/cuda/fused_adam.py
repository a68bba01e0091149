"""Fused Adam: the CUDA kernel's wrapper, its plain version, and the tree
update that routes leaves to it.

Counterpart of ``analytics_zoo_tpu/ops/pallas/fused_adam.py``.
``csrc/fused_adam.cu`` replaces the TPU kernel ``_adam_kernel`` (launched
per leaf by ``_adam_leaf_pallas``): one read of (g, mu, nu) and one write
of (upd, mu', nu') per parameter, with the scalars (lr, b1, b2, eps, bc1,
bc2) in a device array.  Where the TPU launches it once per leaf, the port
launches it once per tree: a table of every kernel leaf goes with one
launch (one per ``TABLE_LEAVES`` leaves of a larger tree).

:func:`fused_update` is the reference's ``_fused_update``: the scalars are
computed once per step on the device (lr at the pre-increment count,
bc = 1 - beta^t at the incremented one), f32 leaves of at least 128
elements go through the kernel and every other leaf takes the same formula
in plain PyTorch (the reference's shape gate, not a fallback).  On the
card the kernel leaves' outputs are views into three flat buffers, one
each for the updates, mu' and nu', at 16-byte aligned offsets that never
overlap, so every leaf stays a tensor of its own.  On the CPU each kernel
leaf goes through :func:`adam_leaf`, which takes :func:`adam_leaf_reference`
for a CPU tensor; :func:`adam_leaf` on a CUDA tensor is a table of one.
``launch_count`` counts the kernel launches, ``leaf_count`` the leaves
they updated, ``plain_count`` the leaves that took the plain version.

:func:`fused_update_` is the same update in place, as the reference's
train step donates its buffers (``donate_argnums=(0, 1, 2)``): mu and nu
become mu' and nu' where they are, and only the updates are new.  The
kernel writes its mu' and nu' outputs at the layout's offsets of two flat
buffers, so in place it takes moments that are views of such buffers
(:func:`in_layout` puts them there once); each element is read and then
written by the same thread, so reading and writing one address is safe.
A captured train step then holds no copy of the moments: the kernel's
launch, its table of pointers included, is replayed as it is.
"""

from __future__ import annotations

import ctypes
import math
from operator import attrgetter

import numpy as np
import torch

launch_count = 0
leaf_count = 0          # leaves updated by the kernel launches
plain_count = 0         # leaves that took the plain version (CPU)

_KERNEL = "fused_adam"
# the reference's gate: leaves smaller than one (8, 128) tile row
# (``g.size >= _LANES``) take the plain formula
MIN_KERNEL_LEAF = 128
_INT32_MAX = 2 ** 31 - 1
# leaves one launch takes (csrc/fused_adam.cu); a larger tree takes more
TABLE_LEAVES = 256


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
    upd, mu2, nu2 = _adam_cuda([g], [mu], [nu], scalars)
    return upd[0], mu2[0], nu2[0]


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


def safe_increment(count):
    """optax's saturating ``safe_increment`` of a 0-d int32 step count, on
    its device."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def adam_scalars(count, lr_fn, b1, b2, eps):
    """(scalars, count_inc): the (6,) f32 device array (lr, b1, b2, eps,
    bc1, bc2) and the incremented step count (optax's saturating
    ``safe_int32_increment``), all computed on ``count``'s device."""
    count_inc = safe_increment(count)
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
    (the plan's ``"xla"`` pick) gives every leaf the plain formula.  The
    kernel leaves on the card go through one launch."""
    n = len(grads)
    out = [None] * n
    table = []  # indices of the kernel leaves on the card
    for i, g in enumerate(grads):
        if kernel and _kernel_leaf(g):
            if g.device.type == "cpu":
                out[i] = adam_leaf(g, mu[i], nu[i], scalars)
            else:
                table.append(i)
        else:
            out[i] = adam_leaf_reference(g, mu[i], nu[i], scalars)
    if table:
        got = _adam_cuda([grads[i] for i in table], [mu[i] for i in table],
                         [nu[i] for i in table], scalars)
        for j, i in enumerate(table):
            out[i] = (got[0][j], got[1][j], got[2][j])
    return ([t[0] for t in out], [t[1] for t in out], [t[2] for t in out])


def fused_update_(grads, mu, nu, scalars, kernel=True):
    """:func:`fused_update` in place: every leaf of ``mu`` and ``nu``
    becomes mu' and nu' (the kernel's leaves on the card written by the
    kernel where they are, which needs them :func:`in_layout`); returns the
    updates.  The same arithmetic, so the same bits."""
    upd = [None] * len(grads)
    table = []
    for i, g in enumerate(grads):
        if kernel and _kernel_leaf(g) and g.device.type != "cpu":
            table.append(i)
            continue
        if kernel and _kernel_leaf(g):
            u, m2, v2 = adam_leaf(g, mu[i], nu[i], scalars)
        else:
            u, m2, v2 = adam_leaf_reference(g, mu[i], nu[i], scalars)
        mu[i].copy_(m2)
        nu[i].copy_(v2)
        upd[i] = u
    if table:
        got = _adam_cuda([grads[i] for i in table], [mu[i] for i in table],
                         [nu[i] for i in table], scalars, in_place=True)[0]
        for j, i in enumerate(table):
            upd[i] = got[j]
    return upd


def _kernel_leaf(t) -> bool:
    """The reference's gate: an f32 leaf of at least MIN_KERNEL_LEAF."""
    return t.dtype == torch.float32 and t.numel() >= MIN_KERNEL_LEAF


def in_layout(leaves) -> list:
    """``leaves`` (moments) with those the kernel updates on the card as
    views of one flat buffer at the kernel layout's offsets, which
    :func:`fused_update_` writes in place: copied there once, or returned
    as they are when they are laid out already.  CPU leaves stay."""
    idx = [i for i, t in enumerate(leaves)
           if _kernel_leaf(t) and t.device.type == "cuda"]
    out = list(leaves)
    if not idx:
        return out
    sel = [leaves[i] for i in idx]
    layout = _Layout([tuple(t.shape) for t in sel])
    if _flat_base(sel, layout) is not None:
        return out
    flat = torch.empty(layout.total, dtype=torch.float32,
                       device=sel[0].device)
    for i, view, t in zip(idx, layout.views(flat), sel):
        out[i] = view.copy_(t)
    return out


def _flat_base(ts, layout):
    """The address of the flat buffer whose views at ``layout``'s offsets
    ``ts`` are, or None when they are not."""
    base = ts[0].data_ptr() - 4 * layout.offsets[0]
    storage = ts[0].untyped_storage().data_ptr()
    for t, off in zip(ts, layout.offsets):
        if t.data_ptr() != base + 4 * off or not t.is_contiguous() \
                or t.untyped_storage().data_ptr() != storage:
            return None
    return base


class _Layout:
    """What one tree structure needs, worked out once: the leaves' shapes,
    their output offsets in the flat buffers (rounded up to 4 elements, 16
    bytes) and the host table the kernel reads, whose pointer columns are
    refilled each step."""

    def __init__(self, shapes):
        self.shapes = shapes
        self.sizes = [math.prod(s) for s in shapes]
        self.strides = [_contiguous_strides(s) for s in shapes]
        self.offsets, total = [], 0
        for size in self.sizes:
            self.offsets.append(total)
            total += -(-size // 4) * 4
        self.total = total
        self.table = np.zeros((len(shapes), 5), np.int64)
        self.table[:, 3] = self.offsets
        self.table[:, 4] = self.sizes
        self.launches = -(-len(shapes) // TABLE_LEAVES)

    def views(self, flat):
        """The leaves of one flat buffer, in order, each shaped and
        contiguous, none overlapping another."""
        return [flat.as_strided(shape, stride, off) for shape, stride, off
                in zip(self.shapes, self.strides, self.offsets)]


def _contiguous_strides(shape):
    strides, step = [], 1
    for d in reversed(shape):
        strides.append(step)
        step *= d
    return tuple(reversed(strides))


_LAYOUTS: dict = {}
_KEY_ATTRS = (attrgetter("shape"), attrgetter("dtype"), attrgetter("device"))


def _layout(grads, mu, nu):
    """The cached layout of this tree structure; checks dtype, device and
    shape of every leaf the first time the structure is seen."""
    key = tuple(tuple(map(attr, ts)) for attr in _KEY_ATTRS
                for ts in (grads, mu, nu))
    layout = _LAYOUTS.get(key)
    if layout is not None:
        return layout
    dev = grads[0].device
    if dev.type != "cuda":
        raise ValueError(f"fused_adam: no kernel for device {dev}")
    for leaf, (g, m, v) in enumerate(zip(grads, mu, nu)):
        for name, t in (("g", g), ("mu", m), ("nu", v)):
            if t.dtype != torch.float32 or t.device != dev \
                    or t.shape != g.shape:
                raise TypeError(
                    f"fused_adam kernel takes f32 g/mu/nu of one shape on "
                    f"one device; leaf {leaf}: {name} is {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    layout = _LAYOUTS[key] = _Layout([tuple(g.shape) for g in grads])
    return layout


def _adam_cuda(grads, mu, nu, scalars, in_place=False):
    """One launch (per ``TABLE_LEAVES`` leaves) over the given f32 leaves:
    lists of (updates, mu', nu'), each leaf a view into a flat buffer; with
    ``in_place`` mu' and nu' are written over mu and nu, which must be laid
    out by :func:`in_layout`."""
    global launch_count, leaf_count
    layout = _layout(grads, mu, nu)
    if scalars.dtype != torch.float32 or scalars.shape != (6,) \
            or scalars.device != grads[0].device:
        raise TypeError("fused_adam kernel takes a (6,) f32 scalar array on "
                        "the leaves' device")
    grads, mu, nu = ([t if t.is_contiguous() else t.contiguous() for t in ts]
                     for ts in (grads, mu, nu))
    table = layout.table.copy()  # the offset and size columns are set
    table[:, 0] = [t.data_ptr() for t in grads]
    table[:, 1] = [t.data_ptr() for t in mu]
    table[:, 2] = [t.data_ptr() for t in nu]
    dev = grads[0].device
    n_new = 1 if in_place else 3
    flats = [torch.empty(layout.total, dtype=torch.float32, device=dev)
             for _ in range(n_new)]
    outs = [f.data_ptr() for f in flats]
    if in_place:
        bases = [_flat_base(ts, layout) for ts in (mu, nu)]
        if None in bases:
            raise ValueError("fused_adam in place takes moments laid out "
                             "by in_layout()")
        outs += bases
    rc = _library().zoo_fused_adam_multi(
        table.ctypes.data, len(grads), scalars.contiguous().data_ptr(),
        *outs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: cudaError {rc}")
    launch_count += layout.launches
    leaf_count += len(grads)
    if in_place:
        return layout.views(flats[0]), mu, nu
    return tuple(layout.views(f) for f in flats)  # while the kernel runs


_LIB = None


def _library():
    """The kernel library, built at first use, with its C signature."""
    global _LIB
    if _LIB is None:
        from analytics_zoo_tpu_torch.ops.cuda.build import load

        lib = load(_KERNEL)
        lib.zoo_fused_adam_multi.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5)
        lib.zoo_fused_adam_multi.restype = ctypes.c_int
        _LIB = lib
    return _LIB
