"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``analytics_zoo_tpu/ops/pallas/flash_attention.py``.  Two
kernels replace the TPU's:

- ``csrc/flash_attention_fwd.cu`` (design note in its ``.cuh``) replaces
  ``_flash_fwd_pallas``: an additive bias broadcast over
  (B|1, H|1, Lq|1, Lk), end-aligned causal masking, ragged lengths, f32 or
  bf16 inputs, in-kernel dropout from the reference's position hash
  (:func:`keep_bits`, ported bit for bit), and the (m, l) statistics the
  backward reads;
- ``csrc/flash_attention_bwd.cu`` replaces ``_flash_bwd_pallas``: dq, dk,
  dv and the bias-gradient partials of a (B|1, H|1, 1, Lk) bias, from the
  saved statistics and the dropout mask re-derived from the same hash.

:func:`flash_attention` is a ``torch.autograd.Function`` around the two.
Dispatch: a CUDA tensor launches the kernels, and anything they do not
take raises; a CPU tensor takes the plain versions,
:func:`attention_reference` and :func:`attention_bwd_reference`, which
compute the same functions in plain PyTorch.  Nothing falls back from one
to the other.  ``launch_count`` and ``bwd_launch_count`` count the calls
that launched the forward and the backward kernels, ``plain_count`` and
``bwd_plain_count`` those that took the plain versions.

Segment ids are not ported yet, and a full (…, Lq, Lk) bias that needs a
gradient raises on CUDA: the reference takes a ``lax.scan``, not its
kernel, for it (ROADMAP queue 2).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import seed_pair

_NEG = -1e30
_U32 = 0xFFFFFFFF

# calls that launched the forward / backward kernels since the counts were
# last reset
launch_count = 0
bwd_launch_count = 0
plain_count = 0         # forwards that took the plain version (CPU)
bwd_plain_count = 0

_FWD = "flash_attention_fwd"
_BWD = "flash_attention_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 192, 256)
_BWD_HEAD_DIMS = (64, 128)

# ---------------------------------------------------------------------------
# The dropout hash (the reference's `_mix32`, `_keep_bits`,
# `_drop_threshold`, `_normalize_seed`, flash_attention.py:73-112)
# ---------------------------------------------------------------------------
_C1, _C2, _C3, _C4 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F


def _mulc(x, c):
    """``x * c`` modulo 2**32 for x < 2**32 held in int64 (tensor or int):
    the constant is split in 16-bit halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mulc(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulc(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_bits(seed0, seed1, b, h, q_pos, k_pos):
    """The reference's uint32 hash, as int64 values in [0, 2**32); the
    shape follows broadcasting of the position tensors."""
    def u(t):
        if torch.is_tensor(t):
            return t.to(torch.int64) & _U32
        return int(t) & _U32

    x = _mulc(u(q_pos), _C1) ^ _mulc(u(k_pos), _C2)
    x = x ^ _mulc(u(b), _C3) ^ _mulc(u(h), _C4)
    x = x ^ u(seed0) ^ _mulc(u(seed1), _C2)
    return _mix32(x)


def drop_threshold(dropout_p: float) -> int:
    """Keep an element when its bits are >= this (floor(p * 2**32))."""
    return min(int(dropout_p * 4294967296.0), 4294967295)


def normalize_seed(seed):
    """(seed0, seed1) as unsigned 32-bit values from an int (-> (seed, 0)),
    a ``torch.Generator`` (:func:`seed_pair`), or one or two integers in a
    tensor, array or sequence (their 32-bit patterns)."""
    if seed is None:
        return None
    if isinstance(seed, torch.Generator):
        return seed_pair(seed)
    if isinstance(seed, (int, np.integer)):
        return int(seed) & _U32, 0
    vals = [int(x) & _U32 for x in np.asarray(
        seed.cpu() if torch.is_tensor(seed) else seed).reshape(-1)[:2]]
    return (vals[0], vals[1] if len(vals) > 1 else 0)


def _keep_mask(seed, dropout_p, b, h, lq, lk, device):
    """(B, H, Lq, Lk) boolean keep mask of the hash."""
    def ar(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, device=device).reshape(shape)

    bits = keep_bits(seed[0], seed[1], ar(b, 0), ar(h, 1), ar(lq, 2),
                     ar(lk, 3))
    return bits >= drop_threshold(dropout_p)


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors; the kernels are held against them on a GPU)
# ---------------------------------------------------------------------------


def _scores(q, k, causal, scale, bias):
    """f32 scores with the bias added and the causal triangle at -1e30, and
    the live mask (None when nothing is masked structurally)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    lq, lk = scores.shape[-2], scores.shape[-1]
    live = None
    if causal:
        live = torch.ones(lq, lk, dtype=torch.bool,
                          device=q.device).tril(lk - lq)
    if bias is not None:
        scores = scores + bias.float()
    if live is not None:
        scores = scores.masked_fill(~live, _NEG)
    return scores, live


def attention_reference(q, k, v, causal, scale, bias=None, dropout_p=0.0,
                        seed=None, return_stats=False):
    """Plain PyTorch attention with the kernel's semantics (the reference's
    ``_attention_reference``): scores in f32, a running-max floor at -1e30
    so a fully masked row comes out as zeros, dropout from the hash with
    the seed pair ``seed``, output in q's dtype.  ``return_stats`` also
    returns the (B, H, Lq) f32 statistics (m, l)."""
    scores, live = _scores(q, k, causal, scale, bias)
    m = scores.amax(dim=-1, keepdim=True).clamp_min(_NEG)
    p = torch.exp(scores - m)
    if live is not None:
        p = p.masked_fill(~live, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    probs = p / l.clamp_min(1e-20)
    if dropout_p > 0.0:
        b, h, lq, lk = probs.shape
        keep = _keep_mask(seed, dropout_p, b, h, lq, lk, q.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
    if return_stats:
        return out, m[..., 0], l[..., 0]
    return out


def _sum_to(x, shape):
    """Sum ``x`` over the dims where ``shape`` is 1 (the bias broadcast)."""
    dims = [i for i, (n, s) in enumerate(zip(x.shape, shape))
            if s == 1 and n != 1]
    return x.sum(dim=dims, keepdim=True) if dims else x


def attention_bwd_reference(q, k, v, g, out, m, l, causal, scale, bias=None,
                            dropout_p=0.0, seed=None, bias_grad=False):
    """Plain backward with the kernel's arithmetic (the reference's
    ``tiles``, flash_attention.py:508): p from the saved (m, l),
    D = rowsum(dO * O), dS = p (t dO.v - D) inside the live select.
    Returns (dq, dk, dv, dbias); dbias has the bias's shape when
    ``bias_grad``, else None."""
    scores, live = _scores(q, k, causal, scale, bias)
    gf = g.float()
    dsum = (gf * out.float()).sum(dim=-1, keepdim=True)
    p = torch.exp(scores - m[..., None]) / l.clamp_min(1e-20)[..., None]
    if live is not None:
        p = p.masked_fill(~live, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, v.float())
    if dropout_p > 0.0:
        b, h, lq, lk = p.shape
        keep = _keep_mask(seed, dropout_p, b, h, lq, lk, q.device)
        t = torch.where(keep, 1.0 / (1.0 - dropout_p), 0.0)
        p_t = p * t
        ds_raw = p * (t * dp - dsum)
    else:
        p_t = p
        ds_raw = p * (dp - dsum)
    if live is not None:
        ds_raw = ds_raw.masked_fill(~live, 0.0)
    ds = ds_raw * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p_t, gf)
    dbias = None
    if bias_grad:
        dbias = _sum_to(ds_raw, bias.shape).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _check_bias(bias, b, h, lq, lk):
    if bias.dim() != 4 or bias.shape[3] != lk or bias.shape[0] not in (1, b) \
            or bias.shape[1] not in (1, h) or bias.shape[2] not in (1, lq):
        raise ValueError(f"bias shape {tuple(bias.shape)} not broadcastable "
                         f"to ({b}|1, {h}|1, {lq}|1, {lk})")


def flash_attention(q, k, v, causal=False, scale=None, *, bias=None,
                    q_segment_ids=None, kv_segment_ids=None, dropout_p=0.0,
                    dropout_seed=None):
    """Fused attention over (B, H, L, D) tensors, differentiable.

    ``bias``: optional additive mask/bias, shape (B|1, H|1, Lq|1, Lk),
    computed in f32.  ``dropout_p`` > 0 needs ``dropout_seed``: an int, a
    ``torch.Generator`` or a (2,) integer pair; the mask comes from the
    position hash, identical in the forward, the backward and the plain
    versions.  Segment ids raise until they are ported.
    """
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError(
            "flash_attention segment ids are not ported yet (ROADMAP "
            "queue 2, flash_attention: segment ids)")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if bias is not None:
        _check_bias(bias, b, h, lq, lk)
    seed = normalize_seed(dropout_seed) if dropout_p > 0.0 else None
    return _FlashAttention.apply(q, k, v, bias, bool(causal), scale,
                                 float(dropout_p), seed)


class _FlashAttention(torch.autograd.Function):
    """Forward and backward kernels on CUDA, plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, dropout_p, seed):
        global plain_count
        grad = any(ctx.needs_input_grad[:4])
        if q.device.type == "cpu":
            plain_count += 1
            out, m, l = attention_reference(q, k, v, causal, scale, bias,
                                            dropout_p, seed,
                                            return_stats=True)
        else:
            out, m, l = _flash_cuda(q, k, v, causal, scale, bias, dropout_p,
                                    seed, stats=grad)
        if grad:
            ctx.save_for_backward(q, k, v, bias, out, m, l)
        ctx.args = (causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_plain_count
        q, k, v, bias, out, m, l = ctx.saved_tensors
        causal, scale, dropout_p, seed = ctx.args
        bias_grad = ctx.needs_input_grad[3]
        if q.device.type == "cpu":
            bwd_plain_count += 1
            dq, dk, dv, dbias = attention_bwd_reference(
                q, k, v, g, out, m, l, causal, scale, bias, dropout_p, seed,
                bias_grad)
        else:
            dq, dk, dv, dbias = _flash_bwd_cuda(
                q, k, v, g, out, m, l, causal, scale, bias, dropout_p, seed,
                bias_grad)
        return dq, dk, dv, dbias, None, None, None, None


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_cuda(q, k, v, head_dims):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if d not in head_dims:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{head_dims}, got {d}")
    if k.shape != (b, h, lk, d) or v.shape != (b, h, lk, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")


def _row_major(t):
    """The kernels read rows through strides but need a contiguous head
    dim."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _bias_args(bias, b, h, lq, lk, device):
    if bias is None:
        return None, (0, 0, 0, 0)
    bias = bias.to(device=device, dtype=torch.float32)
    return bias, bias.expand(b, h, lq, lk).stride()  # 0 on broadcast dims


def _drop_args(dropout_p, seed):
    if dropout_p <= 0.0:
        return 0, 0, 0, 0, 1.0
    return (1, seed[0], seed[1], drop_threshold(dropout_p),
            1.0 / (1.0 - dropout_p))


def _flash_cuda(q, k, v, causal, scale, bias, dropout_p=0.0, seed=None,
                stats=False):
    """Launch the forward kernel: out, and (m, l) when ``stats`` (else
    None, None)."""
    global launch_count
    _check_cuda(q, k, v, _HEAD_DIMS)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    q, k, v = (_row_major(t) for t in (q, k, v))
    bias, bias_strides = _bias_args(bias, b, h, lq, lk, q.device)
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    m = l = None
    if stats:
        m = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    rc = _library(_FWD).zoo_flash_attention_fwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(),
        b, h, lq, lk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *bias_strides, *out.stride()[:3], scale, int(causal),
        *_drop_args(dropout_p, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    launch_count += 1
    return out, m, l


def _flash_bwd_cuda(q, k, v, g, out, m, l, causal, scale, bias,
                    dropout_p=0.0, seed=None, bias_grad=False):
    """Launch the backward kernels: (dq, dk, dv, dbias)."""
    global bwd_launch_count
    _check_cuda(q, k, v, _BWD_HEAD_DIMS)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if bias_grad and bias.shape[2] != 1:
        raise NotImplementedError(
            "the gradient of a full (..., Lq, Lk) attention bias has no "
            "kernel yet (ROADMAP queue 2, flash_attention backward: full "
            "bias)")
    q, k, v, g = (_row_major(t) for t in (q, k, v, g))
    if g.dtype != q.dtype:
        g = g.to(q.dtype)
    bias_f, bias_strides = _bias_args(bias, b, h, lq, lk, q.device)
    # D = rowsum(dO * O) in f32, outside the kernels as in the reference
    dsum = (g.float() * out.float()).sum(dim=-1).contiguous()
    dq = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, lk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    db = (torch.empty((b, h, lk), dtype=torch.float32, device=q.device)
          if bias_grad else None)
    rc = _library(_BWD).zoo_flash_attention_bwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), m.data_ptr(), l.data_ptr(), dsum.data_ptr(),
        None if bias_f is None else bias_f.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), None if db is None else db.data_ptr(),
        b, h, lq, lk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *g.stride()[:3], *bias_strides, scale, int(causal),
        *_drop_args(dropout_p, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError {rc}")
    bwd_launch_count += 1
    dbias = None
    if bias_grad:
        dbias = _sum_to(db[:, :, None, :], bias.shape).to(bias.dtype)
    return dq, dk, dv, dbias


_ARGTYPES = {
    _FWD: ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
           + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 16
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_uint] * 3
           + [ctypes.c_float, ctypes.c_void_p]),
    _BWD: ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 12
           + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 16
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_uint] * 3
           + [ctypes.c_float, ctypes.c_void_p]),
}
_LIBS: dict = {}


def _library(name):
    """A kernel library, built at first use, with its C signature."""
    lib = _LIBS.get(name)
    if lib is None:
        from analytics_zoo_tpu_torch.ops.cuda.build import load

        lib = load(name)
        fn = getattr(lib, "zoo_" + name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
