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

Every loss of the reference's table is here, with its clipping and its
``_align`` of the targets to the predictions' shape: the squared,
absolute, absolute-percentage and squared-logarithmic errors, the binary,
categorical and sparse categorical cross-entropies (on probabilities and
on logits), the Kullback-Leibler divergence, Poisson, cosine proximity,
hinge, squared hinge and the pairwise ``rank_hinge``, under the
reference's short and long names, with the factories
``MeanSquaredError``, ``MeanAbsoluteError``, ``BinaryCrossEntropy``,
``CategoricalCrossEntropy`` and ``SparseCategoricalCrossEntropy`` and the
class ``RankHinge``.
"""

from __future__ import annotations

import math

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


def _align(y_true, y_pred):
    """``y_true`` reshaped to ``y_pred``'s shape when they hold the same
    number of elements (so (B,) targets never broadcast against (B, 1)
    predictions to (B, B)); other shapes raise."""
    ts, ps = tuple(y_true.shape), tuple(y_pred.shape)
    if ts == ps:
        return y_true
    if math.prod(ts) == math.prod(ps):
        return y_true.reshape(ps)
    raise ValueError(
        f"loss target shape {ts} is incompatible with prediction shape {ps}"
    )


def _reduce_rest(x):
    """Mean over all non-batch axes -> (batch,)."""
    if x.dim() <= 1:
        return x
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def _sum_rest(x):
    if x.dim() <= 1:
        return x
    return x.reshape(x.shape[0], -1).sum(dim=-1)


def binary_crossentropy(y_true, y_pred):
    """Probabilities in (0, 1), clipped to [eps, 1 - eps]."""
    y_true = _align(y_true, y_pred)
    y_pred = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return _reduce_rest(
        -(y_true * torch.log(y_pred) + (1.0 - y_true) * torch.log1p(-y_pred))
    )


def binary_crossentropy_from_logits(y_true, logits):
    logits = logits.float()  # f32 cross-entropy under 16-bit compute
    return _reduce_rest(
        torch.clamp(logits, min=0) - logits * y_true
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def categorical_crossentropy(y_true, y_pred):
    """One-hot targets, probability predictions (renormalised, then
    clipped to [eps, 1])."""
    y_pred = y_pred / torch.clamp(y_pred.sum(dim=-1, keepdim=True),
                                  min=_EPS)
    y_pred = torch.clamp(y_pred, _EPS, 1.0)
    return _sum_rest(-y_true * torch.log(y_pred))


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


def mean_squared_error(y_true, y_pred):
    y_true = _align(y_true, y_pred)
    return _reduce_rest((y_pred - y_true) ** 2)


def mean_absolute_error(y_true, y_pred):
    y_true = _align(y_true, y_pred)
    return _reduce_rest(torch.abs(y_pred - y_true))


def mean_absolute_percentage_error(y_true, y_pred):
    y_true = _align(y_true, y_pred)
    diff = torch.abs((y_true - y_pred)
                     / torch.clamp(torch.abs(y_true), min=_EPS))
    return 100.0 * _reduce_rest(diff)


def mean_squared_logarithmic_error(y_true, y_pred):
    y_true = _align(y_true, y_pred)
    a = torch.log(torch.clamp(y_pred, min=_EPS) + 1.0)
    b = torch.log(torch.clamp(y_true, min=_EPS) + 1.0)
    return _reduce_rest((a - b) ** 2)


def kullback_leibler_divergence(y_true, y_pred):
    y_true_c = torch.clamp(y_true, _EPS, 1.0)
    y_pred_c = torch.clamp(y_pred, _EPS, 1.0)
    return _sum_rest(y_true_c * torch.log(y_true_c / y_pred_c))


def poisson(y_true, y_pred):
    y_true = _align(y_true, y_pred)
    return _reduce_rest(y_pred - y_true * torch.log(y_pred + _EPS))


def cosine_proximity(y_true, y_pred):
    def l2(x):
        return x / torch.clamp(torch.linalg.vector_norm(
            x, dim=-1, keepdim=True), min=_EPS)

    return -_sum_rest(l2(y_true) * l2(y_pred))


def hinge(y_true, y_pred):
    y_true = _align(y_true, y_pred)
    return _reduce_rest(torch.clamp(1.0 - y_true * y_pred, min=0.0))


def squared_hinge(y_true, y_pred):
    y_true = _align(y_true, y_pred)
    return _reduce_rest(torch.clamp(1.0 - y_true * y_pred, min=0.0) ** 2)


def rank_hinge(y_true, y_pred, margin: float = 1.0):
    """Pairwise ranking hinge over a batch laid out as alternating
    (positive, negative) rows: ``max(0, margin - pos + neg)`` per pair,
    given to both rows of the pair (the reference's ``rank_hinge``)."""
    pos = y_pred[0::2]
    neg = y_pred[1::2]
    loss = torch.clamp(margin - pos + neg, min=0.0)
    return torch.repeat_interleave(_reduce_rest(loss), 2)[:y_pred.shape[0]]


_LOSSES = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "binary_crossentropy_from_logits": binary_crossentropy_from_logits,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_from_logits":
        sparse_categorical_crossentropy_from_logits,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "rank_hinge": rank_hinge,
}


# the reference's class-style names
def MeanSquaredError():
    return LossFunction(mean_squared_error, "mse")


def MeanAbsoluteError():
    return LossFunction(mean_absolute_error, "mae")


def BinaryCrossEntropy():
    return LossFunction(binary_crossentropy, "binary_crossentropy")


def CategoricalCrossEntropy():
    return LossFunction(categorical_crossentropy, "categorical_crossentropy")


def SparseCategoricalCrossEntropy():
    return LossFunction(sparse_categorical_crossentropy,
                        "sparse_categorical_crossentropy")


class RankHinge(LossFunction):
    """Pairwise ranking hinge with its margin (the reference's
    ``RankHinge``)."""

    def __init__(self, margin: float = 1.0):
        self.margin = margin
        super().__init__(self._fn, "rank_hinge")

    def _fn(self, y_true, y_pred):
        return rank_hinge(y_true, y_pred, self.margin)


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
    raise ValueError(f"unknown loss {identifier!r}")
