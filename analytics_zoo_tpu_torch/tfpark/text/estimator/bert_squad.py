"""BERTSquad (counterpart of
``analytics_zoo_tpu/tfpark/text/estimator/bert_squad.py``; the reference's
pyzoo/zoo/tfpark/text/estimator/bert_squad.py): SQuAD-style extractive
QA, per-token start and end heads."""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_tpu_torch.tfpark.estimator import (
    TFEstimatorSpec,
    clipped_log,
)
from analytics_zoo_tpu_torch.tfpark.text.estimator.bert_base import (
    BERTBaseEstimator,
)


def _squad_nll(sp, ep, y):
    y = y.to(torch.int64)
    nll = 0.0
    for probs, pos in ((sp, y[:, 0]), (ep, y[:, 1])):
        nll = nll - torch.gather(clipped_log(probs), -1,
                                 pos[:, None])[..., 0]
    return nll / 2.0


def _squad_loss(start_probs, end_probs, labels):
    """labels: (B, 2) int start/end positions; mean of the two NLLs (the
    reference averages start_loss and end_loss)."""
    from analytics_zoo_tpu_torch.pipeline.api.autograd import _apply_op

    return _apply_op(_squad_nll, lambda shapes: (shapes[0][0],),
                     "squad_loss", start_probs, end_probs, labels)


class BERTSquad(BERTBaseEstimator):
    def __init__(self, bert_config_file=None, init_checkpoint=None,
                 optimizer=None, model_dir=None, **bert_overrides):
        def head_fn(seq, pooled, labels, mode, params):
            start = Dense(1, name="squad_start")(seq)
            end = Dense(1, name="squad_end")(seq)
            start_p = _token_softmax(start)
            end_p = _token_softmax(end)
            if mode == "predict" or labels is None:
                return TFEstimatorSpec(mode, predictions=[start_p, end_p])
            return TFEstimatorSpec(
                mode, predictions=[start_p, end_p],
                loss=_squad_loss(start_p, end_p, labels))

        super().__init__(head_fn, bert_config_file=bert_config_file,
                         init_checkpoint=init_checkpoint,
                         optimizer=optimizer, model_dir=model_dir,
                         **bert_overrides)


def _softmax_tokens(x):
    return torch.softmax(x[..., 0], dim=-1)


def _token_softmax(logits_3d):
    """(B, L, 1) logits -> (B, L) softmax over tokens."""
    from analytics_zoo_tpu_torch.pipeline.api.autograd import _apply_op

    return _apply_op(_softmax_tokens, lambda s: tuple(s[:-1]),
                     "token_softmax", logits_3d)
