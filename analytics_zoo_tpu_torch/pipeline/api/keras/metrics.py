"""Validation metrics as streaming aggregators (training subset).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/metrics.py``: each
metric maps a batch to a small tuple of device scalars (``batch_stats``),
the estimator sums them over the batches, and ``finalize`` turns the sums
into the value on the host.  Ported so far: ``Accuracy`` (and its
``SparseCategoricalAccuracy``/``CategoricalAccuracy`` names) and ``Loss``;
the others wait for their slice (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import torch


class Metric:
    """Streaming metric: ``batch_stats`` on the device, ``finalize`` on the
    host."""

    name = "metric"
    n_stats = 2

    def batch_stats(self, y_true, y_pred, mask=None):
        """A tuple of scalars to accumulate.  ``mask`` is an optional
        (batch,) 0/1 tensor marking real (non-padded) rows."""
        raise NotImplementedError

    def finalize(self, stats) -> float:
        num, den = stats
        return float(num) / max(float(den), 1e-12)


def _masked_num_den(correct, mask):
    """Sum and count of per-element values, zeroing padded batch rows."""
    if mask is None:
        return correct.sum(), torch.tensor(float(correct.numel()),
                                           device=correct.device)
    m = mask.reshape((mask.shape[0],) + (1,) * (correct.dim() - 1))
    m = m.expand(correct.shape)
    return (correct * m).sum(), m.sum()


class Accuracy(Metric):
    """Binary if the prediction is scalar, else categorical over the last
    axis; integer or one-hot targets (the reference's ``Accuracy``)."""

    name = "accuracy"

    def batch_stats(self, y_true, y_pred, mask=None):
        if y_pred.dim() >= 1 and y_pred.shape[-1] > 1:
            pred = y_pred.argmax(dim=-1)
            if y_true.dim() == y_pred.dim():
                true = y_true.argmax(dim=-1) if y_true.shape[-1] > 1 \
                    else y_true[..., 0]
            else:
                true = y_true
            correct = (pred == true.to(pred.dtype)).float()
        else:
            yp = y_pred[..., 0] if y_pred.dim() > 1 else y_pred
            yt = y_true[..., 0] if y_true.dim() > 1 else y_true
            correct = ((yp > 0.5).to(torch.int32)
                       == yt.to(torch.int32)).float()
        return _masked_num_den(correct, mask)


class SparseCategoricalAccuracy(Accuracy):
    name = "sparse_categorical_accuracy"


class CategoricalAccuracy(Accuracy):
    name = "categorical_accuracy"


class Loss(Metric):
    """The compiled loss as a validation metric."""

    name = "loss"

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn
        self.name = "loss"

    def batch_stats(self, y_true, y_pred, mask=None):
        return _masked_num_den(self.loss_fn(y_true, y_pred), mask)


_METRICS = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
}


def get_metric(identifier) -> Metric:
    if isinstance(identifier, Metric):
        return identifier
    if isinstance(identifier, str) and identifier.lower() in _METRICS:
        return _METRICS[identifier.lower()]()
    if isinstance(identifier, type) and issubclass(identifier, Metric):
        return identifier()
    if isinstance(identifier, str):
        raise NotImplementedError(
            f"metric {identifier!r} is not ported yet or unknown (ROADMAP "
            f"queue 1, item 4); ported: {sorted(_METRICS)}")
    raise ValueError(f"unknown metric {identifier!r}")
