"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``analytics_zoo_tpu/ops/pallas/flash_attention.py``.  Two
kernels replace the TPU's, for any head dim:

- ``csrc/flash_attention_fwd.cu`` (design note in its ``.cuh``) replaces
  ``_flash_fwd_pallas``: on the tensor cores at every head dim that is a
  multiple of 64 (bf16 as it is, f32 as three tf32 products a value,
  3xTF32; above 128 in column chunks that tensor copies bring in), on
  CUDA cores at any other; an additive bias broadcast over
  (B|1, H|1, Lq|1, Lk), end-aligned causal masking, segment ids (packed
  sequences), ragged lengths, f32, bf16 or f16 inputs (softmax math in
  f32, the output in the input type), in-kernel dropout from
  the reference's position hash (:func:`keep_bits`, ported bit for bit),
  and the (m, l) statistics the backward reads;
- ``csrc/flash_attention_bwd.cu`` replaces ``_flash_bwd_pallas``: dq, dk,
  dv and the bias-gradient partials of a (B|1, H|1, 1, Lk) bias, from the
  saved statistics and the dropout mask re-derived from the same hash; on
  the tensor cores at every head dim that is a multiple of 64 (f32 as
  3xTF32, :func:`split_tf32` and :func:`matmul_3xtf32` are its arithmetic
  in plain PyTorch; bf16 and f16 at 64 and 128 on 16-bit ``wgmma``, P t
  and dS rounded to the input type and, in f16, dS lifted by a power of
  two, :func:`attention_bwd16_model` its order in plain PyTorch; above 128
  in 32-column chunks that tensor copies bring in, bf16 and f16 exactly
  in tf32), on CUDA cores at any other.

The gradient of a full (…, Lq, Lk) bias takes neither kernel: as in the
reference (``_bwd``, which leaves it to a blockwise ``lax.scan``), it is
:func:`attention_bwd_blockwise`, plain PyTorch on the tensor's device,
chosen by shape before anything launches.

:func:`flash_attention` is a ``torch.autograd.Function`` around the two.
Dispatch: a CUDA tensor launches the kernels, and anything they do not
take raises; a CPU tensor takes the plain versions,
:func:`attention_reference` and :func:`attention_bwd_reference`, which
compute the same functions in plain PyTorch.  Nothing falls back from one
to the other.  ``launch_count`` and ``bwd_launch_count`` count the calls
that launched the forward and the backward kernels, ``plain_count`` and
``bwd_plain_count`` those that took the plain versions, and
``bwd_blockwise_count`` the backwards that took the blockwise route.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import (
    StepKey,
    pair_tensor,
    seed_pair,
)

_NEG = -1e30
_U32 = 0xFFFFFFFF

# calls that launched the forward / backward kernels since the counts were
# last reset
launch_count = 0
bwd_launch_count = 0
plain_count = 0         # forwards that took the plain version (CPU)
bwd_plain_count = 0
bwd_blockwise_count = 0  # full-bias gradients: the blockwise route

_FWD = "flash_attention_fwd"
_BWD = "flash_attention_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the q/k/v dtypes the kernels take
KERNEL_DTYPES = tuple(_DTYPES)

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
    a ``torch.Generator`` (:func:`seed_pair`), or one or two integers in an
    array or sequence (their 32-bit patterns).  A tensor stays where it
    is, read by the kernels and the plain versions alike: a train step's
    ``StepKey`` gives its site's (2,) int32 pair in device memory, and any
    other integer tensor becomes its first two values' 32-bit patterns
    (one value: (seed, 0)) as a (2,) int32 tensor on its own device."""
    if seed is None:
        return None
    if isinstance(seed, StepKey):
        return seed.flash_seed()
    if torch.is_tensor(seed):
        if seed.dtype == torch.int32 and seed.shape == (2,):
            return seed
        t = seed.reshape(-1)[:2].to(torch.int32)
        return t if t.numel() == 2 else torch.cat([t, t.new_zeros(1)])
    if isinstance(seed, torch.Generator):
        return seed_pair(seed)
    if isinstance(seed, (int, np.integer)):
        return int(seed) & _U32, 0
    vals = [int(x) & _U32 for x in np.asarray(seed).reshape(-1)[:2]]
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
# The kernels' f32 arithmetic on tf32 tensor cores (3xTF32)
# ---------------------------------------------------------------------------
_TF32_LOW = 0x1FFF  # the 13 mantissa bits an f32 has beyond tf32's 10


def split_tf32(x):
    """(hi, lo), f32 tensors with hi + lo == x exactly: hi is x rounded to
    tf32 (10 mantissa bits, to nearest, ties away from zero), lo = x - hi.
    The split the tensor-core kernels make (``split_tf32``,
    ``csrc/sm90.cuh``) before their products."""
    x = x.float().contiguous()
    hi = ((x.view(torch.int32) + 0x1000) & ~_TF32_LOW).view(torch.float32)
    return hi, x - hi


def tf32_read(x):
    """``x`` as a tf32 ``wgmma`` operand reads an f32: its top 19 bits."""
    return (x.float().contiguous().view(torch.int32)
            & ~_TF32_LOW).view(torch.float32)


def matmul_3xtf32(a, b):
    """``a @ b`` as the backward kernel forms it, lo * hi + hi * lo +
    hi * hi of the tf32 pieces, each piece read as ``wgmma`` reads it; the
    products are exact in f64, where they are summed here."""
    a_hi, a_lo = (tf32_read(t).double() for t in split_tf32(a))
    b_hi, b_lo = (tf32_read(t).double() for t in split_tf32(b))
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


# ---------------------------------------------------------------------------
# The 16-bit backward's order of sums (bf16 and f16 at head dims 64 and 128)
# ---------------------------------------------------------------------------
def bwd16_rows(d, kv):
    """Streamed rows a tile of the 16-bit backward (``rows16``,
    ``csrc/flash_attention_bwd.cu``): 64, but 32 in the dk/dv kernel
    (``kv``) at head dim 128."""
    return 32 if d == 128 and kv else 64


def lift_exp(x):
    """The f16 backward's lift of a row whose largest |dS| is ``x`` (f32
    tensor, >= 0): e = 14 - floor(log2 x) clamped to [0, 100], so that
    x 2^e lies in [2^14, 2^15); 100 for 0 and subnormals (``lift_exp``,
    csrc/flash_attention_bwd.cu)."""
    biased = (x.float().contiguous().view(torch.int32) >> 23) & 0xFF
    return (141 - biased).clamp(0, 100)


def _side16(ds, pt, str0, str1, ns, lift):
    """One 16-bit backward kernel on whole tensors, own rows first: per
    ``ns``-row streamed tile, dS (and P t) rounded to the input type as the
    register A operands, the products (exact in f64) added into f32 sums;
    with ``lift`` each own row's dS is lifted by 2^e first, e falling to
    the tile's :func:`lift_exp` where that is lower and the row's sum
    brought to the new scale (powers of two: exact).  Returns (out0, out1);
    out1 is None without ``pt``."""
    dtype = str0.dtype
    shape = ds.shape[:-1] + str0.shape[-1:]
    acc0 = torch.zeros(shape)
    acc1 = None if pt is None else torch.zeros(shape)
    ex = torch.full(ds.shape[:-1] + (1,), 100 if lift else 0)
    for s0 in range(0, ds.shape[-1], ns):
        tile = slice(s0, s0 + ns)
        d = ds[..., tile]
        if lift:
            e = torch.minimum(ex, lift_exp(d.abs().amax(-1, keepdim=True)))
            acc0 = acc0 * torch.exp2((e - ex).float())
            ex = e
            d = d * torch.exp2(ex.float())
        acc0 = (acc0.double() + d.to(dtype).double()
                @ str0[..., tile, :].double()).float()
        if pt is not None:
            acc1 = (acc1.double() + pt[..., tile].to(dtype).double()
                    @ str1[..., tile, :].double()).float()
    return acc0 * torch.exp2(-ex.float()), acc1


def attention_bwd16_model(q, k, v, g, out, m, l, causal, scale, bias=None,
                          dropout_p=0.0, seed=None, bias_grad=False,
                          q_seg=None, kv_seg=None, lift=True,
                          out_dtype=None):
    """The 16-bit backward (``bwd16_kernel``) in plain PyTorch, in the
    kernel's order: p, P t and dS in f32 as :func:`attention_bwd_reference`
    forms them; then dq = scale dS k over key tiles of
    ``bwd16_rows(d, False)`` rows, dk = scale dS^T q and dv = (P t)^T dO
    over query tiles of ``bwd16_rows(d, True)``, with dS and P t rounded to
    the input type (bf16 or f16) as the kernel's register A operands and
    each tile's products added into f32 sums.  f16 lifts each own row's dS
    by a power of two before it is rounded (``lift``; off only to show what
    the lift prevents).  Returns (dq, dk, dv, dbias) as the reference
    does, dq, dk and dv in ``out_dtype`` (default the input type; f32
    gives the kernel's sums before they are rounded)."""
    dtype = q.dtype
    out_dtype = out_dtype or dtype
    b, h, lq, d = q.shape
    lk = k.shape[2]
    gf = g.float()
    dsum = (gf * out.float()).sum(dim=-1)
    live = _live(lq, lk, causal, q_seg, kv_seg, q.device)
    ds, pt = _tile_grads(
        q.float(), gf, k.float(), v.float(), m, l.clamp_min(1e-20), dsum,
        live, scale, None if bias is None else bias.float(),
        _keep_scale(seed, dropout_p, b, h, lq, 0, lk, q.device))[:2]
    f16 = lift and dtype == torch.float16
    dq, _ = _side16(ds, None, k, None, bwd16_rows(d, False), f16)
    dk, dv = _side16(ds.transpose(-1, -2), pt.transpose(-1, -2), q, g,
                     bwd16_rows(d, True), f16)
    dbias = _sum_to(ds, bias.shape).to(bias.dtype) if bias_grad else None
    return ((dq * scale).to(out_dtype), (dk * scale).to(out_dtype),
            dv.to(out_dtype), dbias)


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors; the kernels are held against them on a GPU)
# ---------------------------------------------------------------------------


def _live(lq, lk, causal, q_seg, kv_seg, device):
    """The structural live mask: the end-aligned causal triangle (Lq, Lk)
    and equal segment ids (B, 1, Lq, Lk), combined; None when neither
    masks anything."""
    live = None
    if causal:
        live = torch.ones(lq, lk, dtype=torch.bool, device=device).tril(
            lk - lq)
    if q_seg is not None:
        seg = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        live = seg if live is None else live & seg
    return live


def _scores(q, k, causal, scale, bias, q_seg=None, kv_seg=None):
    """f32 scores with the bias added and the masked pairs at -1e30, and
    the live mask (None when nothing is masked structurally)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    live = _live(scores.shape[-2], scores.shape[-1], causal, q_seg, kv_seg,
                 q.device)
    if bias is not None:
        scores = scores + bias.float()
    if live is not None:
        scores = scores.masked_fill(~live, _NEG)
    return scores, live


def attention_reference(q, k, v, causal, scale, bias=None, dropout_p=0.0,
                        seed=None, return_stats=False, q_seg=None,
                        kv_seg=None):
    """Plain PyTorch attention with the kernel's semantics (the reference's
    ``_attention_reference``): scores in f32, a (q, k) pair live where the
    causal triangle and equal segment ids allow it, a running-max floor at
    -1e30 so a fully masked row comes out as zeros, dropout from the hash
    with the seed pair ``seed``, output in q's dtype.  ``return_stats``
    also returns the (B, H, Lq) f32 statistics (m, l)."""
    scores, live = _scores(q, k, causal, scale, bias, q_seg, kv_seg)
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


def _tile_grads(qf, gf, kb, vb, m, l_safe, dsum, live, scale, bias_blk,
                keep_t):
    """One (all queries, key block) tile of the backward: p from the saved
    (m, l), dS = p (t dO.v - D) inside the live select.  Returns
    (ds_raw, p_t, dq_part, dk, dv) in f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
    if bias_blk is not None:
        s = s + bias_blk
    p = torch.exp(s - m[..., None]) / l_safe[..., None]
    if live is not None:
        p = p.masked_fill(~live, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vb)
    if keep_t is not None:
        p_t = p * keep_t
        ds_raw = p * (keep_t * dp - dsum[..., None])
    else:
        p_t = p
        ds_raw = p * (dp - dsum[..., None])
    if live is not None:
        ds_raw = ds_raw.masked_fill(~live, 0.0)
    ds = ds_raw * scale
    return (ds_raw, p_t, torch.einsum("bhqk,bhkd->bhqd", ds, kb),
            torch.einsum("bhqk,bhqd->bhkd", ds, qf),
            torch.einsum("bhqk,bhqd->bhkd", p_t, gf))


def _keep_scale(seed, dropout_p, b, h, lq, k0, k1, device):
    """1/(1-p) where the hash keeps a (q, k) pair of keys k0 .. k1 - 1, else
    0; None without dropout."""
    if dropout_p <= 0.0:
        return None
    bits = keep_bits(seed[0], seed[1],
                     torch.arange(b, device=device).reshape(b, 1, 1, 1),
                     torch.arange(h, device=device).reshape(1, h, 1, 1),
                     torch.arange(lq, device=device).reshape(1, 1, lq, 1),
                     torch.arange(k0, k1, device=device).reshape(1, 1, 1, -1))
    return torch.where(bits >= drop_threshold(dropout_p),
                       1.0 / (1.0 - dropout_p), 0.0)


def attention_bwd_reference(q, k, v, g, out, m, l, causal, scale, bias=None,
                            dropout_p=0.0, seed=None, bias_grad=False,
                            q_seg=None, kv_seg=None):
    """Plain backward with the kernel's arithmetic (the reference's
    ``tiles``, flash_attention.py:508): p from the saved (m, l),
    D = rowsum(dO * O), dS = p (t dO.v - D) inside the live select.
    Returns (dq, dk, dv, dbias); dbias has the bias's shape when
    ``bias_grad``, else None."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    gf = g.float()
    dsum = (gf * out.float()).sum(dim=-1)
    live = _live(lq, lk, causal, q_seg, kv_seg, q.device)
    ds_raw, _, dq, dk, dv = _tile_grads(
        q.float(), gf, k.float(), v.float(), m, l.clamp_min(1e-20), dsum,
        live, scale, None if bias is None else bias.float(),
        _keep_scale(seed, dropout_p, b, h, lq, 0, lk, q.device))
    dbias = None
    if bias_grad:
        dbias = _sum_to(ds_raw, bias.shape).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def attention_bwd_blockwise(q, k, v, g, out, m, l, causal, scale, bias=None,
                            dropout_p=0.0, seed=None, q_seg=None,
                            kv_seg=None):
    """The backward the reference takes for the gradient of a full
    (…, Lq, Lk) bias (``_bwd``, flash_attention.py:893-1014, its second
    pass: the forward saved (m, l)), in plain PyTorch on the tensors'
    device: key blocks of at most 256, each (Lq, block) score tile
    recomputed from q and k, dropout re-derived from the hash; dq summed
    over the blocks, dk, dv and the bias gradient written block by block.
    Returns (dq, dk, dv, dbias); dbias has the bias's shape (None without
    a bias)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bk = min(256, lk)
    qf, gf = q.float(), g.float()
    l_safe = l.clamp_min(1e-20)
    dsum = (gf * out.float()).sum(dim=-1)
    live_all = _live(lq, lk, causal, q_seg, kv_seg, q.device)
    dq = torch.zeros_like(qf)
    dk = torch.empty((b, h, lk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, lk, d), dtype=v.dtype, device=q.device)
    dbias = None if bias is None else torch.empty(
        bias.shape, dtype=bias.dtype, device=q.device)
    for k0 in range(0, lk, bk):
        k1 = min(k0 + bk, lk)
        ds_raw, _, dq_part, dkb, dvb = _tile_grads(
            qf, gf, k[:, :, k0:k1].float(), v[:, :, k0:k1].float(), m,
            l_safe, dsum,
            None if live_all is None else live_all[..., k0:k1], scale,
            None if bias is None else bias[..., k0:k1].float(),
            _keep_scale(seed, dropout_p, b, h, lq, k0, k1, q.device))
        dq += dq_part
        dk[:, :, k0:k1] = dkb
        dv[:, :, k0:k1] = dvb
        if bias is not None:
            dbias[..., k0:k1] = _sum_to(ds_raw, bias.shape[:3] + (k1 - k0,))
    return dq.to(q.dtype), dk, dv, dbias


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _check_bias(bias, b, h, lq, lk):
    if bias.dim() != 4 or bias.shape[3] != lk or bias.shape[0] not in (1, b) \
            or bias.shape[1] not in (1, h) or bias.shape[2] not in (1, lq):
        raise ValueError(f"bias shape {tuple(bias.shape)} not broadcastable "
                         f"to ({b}|1, {h}|1, {lq}|1, {lk})")


def _segment_ids(ids, b, n, which, device):
    """(B, n) integer segment ids as a tensor on ``device``."""
    ids = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids)
                          else ids, device=device)
    if ids.shape != (b, n) or ids.dtype.is_floating_point \
            or ids.dtype == torch.bool:
        raise ValueError(f"{which} must be ({b}, {n}) integers, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    return ids


def flash_attention(q, k, v, causal=False, scale=None, *, bias=None,
                    q_segment_ids=None, kv_segment_ids=None, dropout_p=0.0,
                    dropout_seed=None):
    """Fused attention over (B, H, L, D) tensors, differentiable.

    ``bias``: optional additive mask/bias, shape (B|1, H|1, Lq|1, Lk),
    computed in f32.  ``q_segment_ids`` / ``kv_segment_ids``: optional
    (B, Lq) / (B, Lk) integers, given together; a query sees only the keys
    of its own segment (packed sequences).  ``dropout_p`` > 0 needs
    ``dropout_seed``: an int, a ``torch.Generator`` or a (2,) integer pair;
    the mask comes from the position hash, identical in the forward, the
    backward and the plain versions.
    """
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be given "
                         "together")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if bias is not None:
        _check_bias(bias, b, h, lq, lk)
    q_seg = kv_seg = None
    if q_segment_ids is not None:
        q_seg = _segment_ids(q_segment_ids, b, lq, "q_segment_ids", q.device)
        kv_seg = _segment_ids(kv_segment_ids, b, lk, "kv_segment_ids",
                              q.device)
    seed = normalize_seed(dropout_seed) if dropout_p > 0.0 else None
    return _FlashAttention.apply(q, k, v, bias, q_seg, kv_seg, bool(causal),
                                 scale, float(dropout_p), seed)


class _FlashAttention(torch.autograd.Function):
    """Forward and backward kernels on CUDA, plain versions on the CPU;
    the gradient of a full bias on the blockwise route on either."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_seg, kv_seg, causal, scale, dropout_p,
                seed):
        global plain_count
        grad = any(ctx.needs_input_grad[:4])
        if q.device.type == "cpu":
            plain_count += 1
            out, m, l = attention_reference(q, k, v, causal, scale, bias,
                                            dropout_p, seed,
                                            return_stats=True, q_seg=q_seg,
                                            kv_seg=kv_seg)
        else:
            if dropout_p > 0.0:
                seed = _seed_on(seed, q.device)  # the backward's too
            out, m, l = _flash_cuda(q, k, v, causal, scale, bias, dropout_p,
                                    seed, stats=grad, q_seg=q_seg,
                                    kv_seg=kv_seg)
        if grad:
            ctx.save_for_backward(q, k, v, bias, q_seg, kv_seg, out, m, l)
        ctx.args = (causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_plain_count, bwd_blockwise_count
        q, k, v, bias, q_seg, kv_seg, out, m, l = ctx.saved_tensors
        causal, scale, dropout_p, seed = ctx.args
        bias_grad = ctx.needs_input_grad[3]
        args = (q, k, v, g, out, m, l, causal, scale, bias, dropout_p, seed)
        if bias_grad and bias.shape[2] > 1:
            # a full bias's gradient: the reference's blockwise route,
            # decided by shape before anything launches
            bwd_blockwise_count += 1
            dq, dk, dv, dbias = attention_bwd_blockwise(
                *args, q_seg=q_seg, kv_seg=kv_seg)
        elif q.device.type == "cpu":
            bwd_plain_count += 1
            dq, dk, dv, dbias = attention_bwd_reference(
                *args, bias_grad, q_seg=q_seg, kv_seg=kv_seg)
        else:
            dq, dk, dv, dbias = _flash_bwd_cuda(
                *args, bias_grad, q_seg=q_seg, kv_seg=kv_seg)
        return dq, dk, dv, dbias, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_cuda(q, k, v):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes float32, bfloat16 "
                        f"or float16 q/k/v of one dtype, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype}")
    if k.shape != (b, h, lk, d) or v.shape != (b, h, lk, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")


def _row_major(t):
    """The kernels read rows through strides but need a contiguous head
    dim."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _tma_ready(t):
    """The kernels that read their inputs with tensor copies (the chunked
    bodies at head dims above 128 that are multiples of 64, and the 16-bit
    backward at 64 and 128) need the base and the batch, head and row
    strides in multiples of 16 bytes."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * es % 16 == 0 for s in t.stride()[:3])


def _kernel_inputs(d, *ts, backward=False):
    """``ts`` as the kernels take them: a contiguous head dim, and a copy
    of any tensor that tensor copies cannot read (:func:`_tma_ready`) where
    the kernel reads with them: at head dims above 128 that are multiples
    of 64 (the chunked kernels) and, for the ``backward`` of bf16 or f16,
    at 64 and 128 too."""
    ts = [_row_major(t) for t in ts]
    tma = d > 128 and d % 64 == 0
    if backward and ts[0].dtype in (torch.bfloat16, torch.float16):
        tma = tma or d in (64, 128)
    if tma:
        ts = [t if _tma_ready(t) else
              t.clone(memory_format=torch.contiguous_format) for t in ts]
    return ts


def _stream(device):
    """The current CUDA stream of ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def _check_rc(rc, what):
    if rc == -2:
        raise RuntimeError(f"{what} launch failed: an input's base or "
                           f"strides are not multiples of 16 bytes, which "
                           f"the kernels' tensor copies need")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _bias_args(bias, b, h, lq, lk, device):
    if bias is None:
        return None, (0, 0, 0, 0)
    bias = bias.to(device=device, dtype=torch.float32)
    return bias, bias.expand(b, h, lq, lk).stride()  # 0 on broadcast dims


def _seg_args(q_seg, kv_seg, device):
    """The kernels read segment ids as contiguous (B, L) int32."""
    if q_seg is None:
        return None, None
    return tuple(t.to(device=device, dtype=torch.int32).contiguous()
                 for t in (q_seg, kv_seg))


def _ptr(t):
    return None if t is None else t.data_ptr()


_HOST_SEEDS: dict = {}  # (pair, device) -> its device copy
_HOST_SEEDS_KEPT = 256


def _seed_on(seed, device):
    """The seed pair as the kernels read it: a (2,) int32 tensor on
    ``device``.  A host pair is copied there once, without waiting for the
    device, and kept (the last ``_HOST_SEEDS_KEPT`` pairs), so repeated
    calls with one pair, captured ones too, read one buffer."""
    if torch.is_tensor(seed):
        return seed if seed.device == device else seed.to(device)
    key = (tuple(seed), str(device))
    t = _HOST_SEEDS.get(key)
    if t is None:
        while len(_HOST_SEEDS) >= _HOST_SEEDS_KEPT:
            _HOST_SEEDS.pop(next(iter(_HOST_SEEDS)))
        t = _HOST_SEEDS[key] = pair_tensor(seed, device)
    return t


def _drop_args(dropout_p, seed, device):
    """(dropout, seed pointer, threshold, 1/(1-p)): the kernels read the
    (seed0, seed1) pair from device memory, once per block."""
    if dropout_p <= 0.0:
        return 0, None, 0, 1.0
    seed = _seed_on(seed, device)
    if seed.dtype != torch.int32 or seed.shape != (2,) \
            or not seed.is_contiguous():
        raise ValueError(f"the flash kernels read the seed pair as a "
                         f"contiguous (2,) int32 tensor, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    return (1, seed.data_ptr(), drop_threshold(dropout_p),
            1.0 / (1.0 - dropout_p))


def _flash_cuda(q, k, v, causal, scale, bias, dropout_p=0.0, seed=None,
                stats=False, q_seg=None, kv_seg=None):
    """Launch the forward kernel: out, and (m, l) when ``stats`` (else
    None, None)."""
    global launch_count
    _check_cuda(q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    device = q.device
    q, k, v = _kernel_inputs(d, q, k, v)
    bias, bias_strides = _bias_args(bias, b, h, lq, lk, device)
    q_seg, kv_seg = _seg_args(q_seg, kv_seg, device)
    out = q.new_empty((b, h, lq, d))
    m = l = None
    if stats:
        m = q.new_empty((b, h, lq), dtype=torch.float32)
        l = torch.empty_like(m)
    rc = _library(_FWD).zoo_flash_attention_fwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(bias), out.data_ptr(), _ptr(m), _ptr(l), _ptr(q_seg),
        _ptr(kv_seg), b, h, lq, lk, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *bias_strides, *out.stride()[:3], scale,
        int(causal), *_drop_args(dropout_p, seed, device), _stream(device))
    _check_rc(rc, "flash_attention kernel")
    launch_count += 1
    return out, m, l


def _flash_bwd_cuda(q, k, v, g, out, m, l, causal, scale, bias,
                    dropout_p=0.0, seed=None, bias_grad=False, q_seg=None,
                    kv_seg=None):
    """Launch the backward kernels: (dq, dk, dv, dbias).  A bias gradient
    comes from the kernels for a (B|1, H|1, 1, Lk) bias only: a full
    bias's takes :func:`attention_bwd_blockwise`, which the autograd
    Function picks before it gets here."""
    global bwd_launch_count
    _check_cuda(q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if bias_grad and bias.shape[2] != 1:
        raise ValueError("the backward kernels give the gradient of a "
                         "(B|1, H|1, 1, Lk) bias only; a full bias's is "
                         "attention_bwd_blockwise")
    if g.dtype != q.dtype:
        g = g.to(q.dtype)
    q, k, v, g = _kernel_inputs(d, q, k, v, g, backward=True)
    bias_f, bias_strides = _bias_args(bias, b, h, lq, lk, q.device)
    q_seg, kv_seg = _seg_args(q_seg, kv_seg, q.device)
    # D = rowsum(dO * O) in f32, outside the kernels as in the reference
    # (O widens to f32 inside the product, exactly)
    dsum = (g.float() * out).sum(dim=-1).contiguous()
    dq = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, lk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    db = (torch.empty((b, h, lk), dtype=torch.float32, device=q.device)
          if bias_grad else None)
    rc = _library(_BWD).zoo_flash_attention_bwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), m.data_ptr(), l.data_ptr(), dsum.data_ptr(),
        _ptr(bias_f), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(db),
        _ptr(q_seg), _ptr(kv_seg), b, h, lq, lk, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *g.stride()[:3], *bias_strides,
        scale, int(causal), *_drop_args(dropout_p, seed, q.device),
        _stream(q.device))
    _check_rc(rc, "flash_attention backward")
    bwd_launch_count += 1
    dbias = None
    if bias_grad:
        dbias = _sum_to(db[:, :, None, :], bias.shape).to(bias.dtype)
    return dq, dk, dv, dbias


# ... scale, causal, dropout, seed (a device pointer), drop_thr, inv_keep,
# stream
_ARGTYPES = {
    _FWD: ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
           + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 16
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]),
    _BWD: ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 14
           + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 16
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]),
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
