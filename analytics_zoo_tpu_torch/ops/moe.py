"""Routed mixture-of-experts feed-forward for the Keras model surface.

Counterpart of ``analytics_zoo_tpu/ops/moe.py``: GShard/Switch top-k
routing with a per-expert capacity, expressed as dense one-hot dispatch
and combine einsums (the reference computes them outside any Pallas
kernel; here they are ``torch.einsum``, i.e. batched cuBLAS products).

Capacity (GShard): every token proposes its top-k experts; the assignment
stream is priority-ordered (all first choices outrank any second choice)
and each expert takes at most ``C = ceil(cf * k * S / E)`` tokens per group
(one batch row), a host int from the static shapes.  An over-capacity
assignment contributes zero, so the op sits behind a residual connection
(``_TransformerCore._block_forward_aux``): a dropped token passes through
unchanged.

Routing runs in f32 whatever the compute dtype, as in the reference.  The
top-k is a stable descending sort: ``jax.lax.top_k`` puts the lower expert
index first among equal probabilities, and ``torch.topk`` on CUDA promises
no order among ties.  Nothing reads a value back to the host, so a captured
train step records the whole op.

The reference pins the expert dimension to a mesh ``expert`` axis when the
context mesh has one (``_constrain_expert_axis``); on one device that is a
no-op, and the expert-parallel half waits for ROADMAP queue 1 item 14.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def aux_cost_leaves(state) -> list:
    """Every ``moe_aux_cost`` leaf of a model state tree, in order."""
    out = []
    if isinstance(state, dict):
        for k, v in state.items():
            if k == "moe_aux_cost" and torch.is_tensor(v):
                out.append(v)
            else:
                out.extend(aux_cost_leaves(v))
    elif isinstance(state, (list, tuple)):
        for v in state:
            out.extend(aux_cost_leaves(v))
    return out


def collect_aux_cost(state):
    """The sum of every ``moe_aux_cost`` leaf of a model state tree (the
    pre-weighted load-balancing losses MoE stacks report through the layer
    state), as an f32 scalar; zero where there is none.  A train step adds
    it to the task loss, or a collapsed router trains unpenalized."""
    total = None
    for leaf in aux_cost_leaves(state):
        total = leaf.float() if total is None else total + leaf.float()
    return torch.zeros((), dtype=torch.float32) if total is None else total


def routed_ffn(h, gate_w, w1, b1, w2, b2, *, top_k=2, capacity_factor=1.25,
               activation=None, renormalize=False):
    """Top-k routed MoE feed-forward on (B, S, D) activations.

    ``gate_w`` (D, E) is the router, ``w1`` (E, D, F), ``b1`` (E, F), ``w2``
    (E, F, D), ``b2`` (D,); ``activation`` defaults to the tanh-approximate
    gelu (``jax.nn.gelu``'s default); ``renormalize`` rescales the k gate
    values to sum to 1 (GShard top-2), off by default (Switch: the raw
    softmax probabilities).

    Returns ``(y, aux, drop_fraction)``: y (B, S, D), zero rows for fully
    dropped tokens; aux, the f32 load-balancing loss ``E * sum_e
    mean_prob_e * frac_first_choice_e``; drop_fraction, the f32 fraction of
    the k·B·S assignments over capacity.
    """
    if activation is None:
        def activation(x):
            return F.gelu(x, approximate="tanh")
    b, s, d = h.shape
    e = gate_w.shape[-1]
    if top_k > e:
        raise ValueError(f"top_k={top_k} > n_experts={e}")
    cap = int(math.ceil(capacity_factor * top_k * s / e))
    cap = max(1, min(cap, s))

    probs = torch.softmax(h.float() @ gate_w.float(), dim=-1)  # (B, S, E)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals = ranked.values[..., :top_k]                       # (B, S, k)
    top_idx = ranked.indices[..., :top_k]
    if renormalize:
        top_vals = top_vals / top_vals.sum(-1, keepdim=True)

    # priority-ordered capacity race: choice j's position within an expert
    # counts every earlier token's j-th choice and all previous choices
    counts = torch.zeros((b, 1, e), dtype=torch.float32, device=h.device)
    dispatch = torch.zeros((b, s, e, cap), dtype=h.dtype, device=h.device)
    combine = torch.zeros_like(dispatch)
    kept = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(top_k):
        m = F.one_hot(top_idx[..., j], e).float()
        pos = torch.cumsum(m, dim=1) - 1.0 + counts              # (B, S, E)
        keep = m * (pos < cap)
        slot = F.one_hot(pos.clamp(0, cap - 1).long(), cap).float()
        dc = (keep[..., None] * slot).to(h.dtype)                # (B,S,E,C)
        dispatch = dispatch + dc
        combine = combine + dc * top_vals[..., j, None, None].to(h.dtype)
        counts = counts + m.sum(dim=1, keepdim=True)
        kept = kept + keep.sum()

    # each expert's C tokens per group: (E, B, C, D) -> (E, B*C, D)
    xin = torch.einsum("bsec,bsd->ebcd", dispatch, h).reshape(e, b * cap, d)
    h1 = activation(torch.einsum("etd,edf->etf", xin, w1) + b1[:, None, :])
    # b2 joins inside the expert output, before the gate-weighted combine:
    # a fully dropped token's row stays exactly zero
    ye = (torch.einsum("etf,efd->etd", h1, w2)
          + b2[None, None, :]).reshape(e, b, cap, d)
    y = torch.einsum("bsec,ebcd->bsd", combine, ye)

    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = F.one_hot(top_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * (me * ce).sum()
    drop_fraction = 1.0 - kept / float(top_k * b * s)
    return y, aux, drop_fraction
