"""Attention ops — the single entry point every attention layer routes
through.

Counterpart of ``analytics_zoo_tpu/ops/attention.py`` with the same
routing: shapes the flash kernel takes go to
:func:`analytics_zoo_tpu_torch.ops.cuda.flash_attention.flash_attention`
(the CUDA kernel for a CUDA tensor, its plain version for a CPU tensor);
every other shape takes the dense path, because that is what the
reference computes there.  A plan's ``kernel_rules`` override the ``auto``
routing, as in the reference: ``resolve_kernel("attention")`` of ``"xla"``
pins the dense path (on the card too), ``"flash"`` asks for the kernel
(eligibility still gates it).  The two differ on a row whose keys are all
masked: the dense softmax gives a uniform row, flash gives zeros.

Attention dropout: on the flash route the mask comes from the kernel's
position hash, seeded with the (seed0, seed1) pair of the call's generator
(:func:`~analytics_zoo_tpu_torch.common.engine.seed_pair`; a train step's
``StepKey`` gives the same pair in device memory), so it is the
reference's mask for the same pair and the same on every device.  The
dense route draws its mask from the generator with ``torch.rand``; the
reference draws it with ``jax.random.bernoulli``, so that mask is not
bit-identical to the reference's, only equal in distribution.
"""

from __future__ import annotations

import math

import torch

from analytics_zoo_tpu_torch.common.engine import generator_of
from analytics_zoo_tpu_torch.ops.cuda.flash_attention import (
    _NEG,
    flash_attention,
)
from analytics_zoo_tpu_torch.parallel.plan import resolve_kernel


def flash_eligible(q_shape, mask_shape, mask_ndim, dropout_p, has_rng,
                   k_len, use_flash="auto"):
    """Pure routing predicate, as in the reference.

    ``mask_shape`` is None or the mask's shape; flash takes masks
    broadcastable to (B|1, H|1, Lq|1, Lk).  Dropout needs an rng to derive
    the kernel seed.
    """
    if use_flash == False:  # noqa: E712
        return False
    b, h_, lq, d = q_shape[-4], q_shape[-3], q_shape[-2], q_shape[-1]
    if lq < 256 or d % 64 != 0:
        return False
    if dropout_p > 0.0 and not has_rng:
        return False
    if mask_shape is not None:
        if mask_ndim != 4:
            return False
        if (mask_shape[0] not in (1, b) or mask_shape[1] not in (1, h_)
                or mask_shape[2] not in (1, lq)
                or mask_shape[3] != k_len):
            return False
    return True


def dot_product_attention(q, k, v, mask=None, dropout_p=0.0, rng=None,
                          causal=False, scale=None, use_flash="auto"):
    """Batched multi-head attention.

    Args:
      q, k, v: (B, H, L, D) tensors.
      mask: optional additive mask broadcastable to (B, H, Lq, Lk) — 0 for
        keep, large-negative for drop — or a boolean mask (True = keep).
      dropout_p: attention-prob dropout, applied when ``rng`` (a
        ``torch.Generator`` on q's device, or a train step's ``StepKey``)
        is given.
      causal: end-aligned lower-triangular masking.
      scale: score scale; defaults to 1/sqrt(D).
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if use_flash == "auto":
        pick = resolve_kernel("attention")
        if pick == "xla":
            use_flash = False
        elif pick == "flash":
            use_flash = True
    if flash_eligible(q.shape, None if mask is None else mask.shape,
                      None if mask is None else mask.dim(), dropout_p,
                      rng is not None, k.shape[-2], use_flash):
        bias = None
        if mask is not None:
            if mask.dtype == torch.bool:
                bias = torch.where(mask, 0.0, _NEG).float()
            else:
                bias = mask.float()
        return flash_attention(
            q, k, v, causal, scale, bias=bias, dropout_p=float(dropout_p),
            dropout_seed=rng if dropout_p > 0.0 else None)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    neg = torch.finfo(scores.dtype).min
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        causal_mask = torch.ones(lq, lk, dtype=torch.bool,
                                 device=q.device).tril(lk - lq)
        scores = scores.masked_fill(~causal_mask, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, neg)
        else:
            scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0 and rng is not None:
        keep = torch.rand(probs.shape, generator=generator_of(rng),
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def split_heads(x, n_heads):
    """(B, L, H*D) -> (B, H, L, D)."""
    b, l, hd = x.shape
    d = hd // n_heads
    return x.reshape(b, l, n_heads, d).transpose(1, 2)


def merge_heads(x):
    """(B, H, L, D) -> (B, L, H*D)."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)
