"""Loss functions — Keras-1 names (training subset).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/objectives.py``, with
its contract: a loss is ``fn(y_true, y_pred) -> (batch,)`` per-sample
values, and :meth:`LossFunction.mean` takes the (optionally weighted)
mean the training loop differentiates.

``sparse_categorical_crossentropy_from_logits`` routes plain (B, V) logits
with (B,) labels to the fused softmax cross-entropy
(``ops/cuda/fused_softmax_xent.py``): the CUDA kernels on the card, their
plain version on the CPU.  That is the port's ``loss.softmax_xent`` scope,
which the JAX package routes the same way under ``ZOO_USE_PALLAS=1``;
every other shape, and a plan whose ``kernel_rules`` pick ``"xla"`` for
the scope, takes the f32 log-softmax path, as there.

Ported so far: the two sparse categorical cross-entropies; the other
losses wait for their slice (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.ops.cuda.fused_softmax_xent import softmax_xent
from analytics_zoo_tpu_torch.parallel.plan import resolve_kernel

_EPS = 1e-7


class LossFunction:
    """Callable loss with a name; subclass or wrap a function."""

    def __init__(self, fn, name):
        self.fn = fn
        self.name = name

    def __call__(self, y_true, y_pred):
        return self.fn(y_true, y_pred)

    def mean(self, y_true, y_pred, sample_weight=None):
        per_sample = self(y_true, y_pred)
        if sample_weight is not None:
            return torch.sum(per_sample * sample_weight) / (
                torch.sum(sample_weight) + _EPS)
        return torch.mean(per_sample)


def _labels(y_true, ndim):
    labels = y_true.to(torch.int64)
    if labels.dim() == ndim:
        labels = labels.squeeze(-1)
    return labels


def _picked_mean(picked):
    if picked.dim() > 1:
        picked = picked.reshape(picked.shape[0], -1).mean(dim=-1)
    return -picked


def sparse_categorical_crossentropy(y_true, y_pred):
    """Integer targets, probability predictions (zero-based labels)."""
    logp = torch.log(torch.clamp(y_pred, _EPS, 1.0))
    labels = _labels(y_true, logp.dim())
    return _picked_mean(logp.gather(-1, labels[..., None])[..., 0])


def sparse_categorical_crossentropy_from_logits(y_true, logits):
    labels = _labels(y_true, logits.dim())
    if logits.dim() == 2 and labels.dim() == 1 \
            and resolve_kernel("loss.softmax_xent") != "xla":
        return softmax_xent(logits, labels)
    # f32 softmax-CE regardless of compute dtype, as in the reference
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _picked_mean(logp.gather(-1, labels[..., None])[..., 0])


_LOSSES = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_from_logits":
        sparse_categorical_crossentropy_from_logits,
}


def get_loss(identifier) -> LossFunction:
    if isinstance(identifier, LossFunction):
        return identifier
    if callable(identifier):
        return LossFunction(identifier,
                            getattr(identifier, "__name__", "custom"))
    if isinstance(identifier, str):
        key = identifier.lower()
        if key in _LOSSES:
            return LossFunction(_LOSSES[key], key)
        raise NotImplementedError(
            f"loss {identifier!r} is not ported yet or unknown (ROADMAP "
            f"queue 1, item 4); ported: {sorted(_LOSSES)}")
    raise ValueError(f"unknown loss {identifier!r}")
