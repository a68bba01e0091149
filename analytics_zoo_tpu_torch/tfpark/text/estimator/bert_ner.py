"""BERTNER (counterpart of
``analytics_zoo_tpu/tfpark/text/estimator/bert_ner.py``; the reference's
pyzoo/zoo/tfpark/text/estimator/bert_ner.py): sequence output -> dropout
-> per-token dense softmax tagger."""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense, Dropout
from analytics_zoo_tpu_torch.tfpark.estimator import (
    TFEstimatorSpec,
    sparse_ce,
)
from analytics_zoo_tpu_torch.tfpark.text.estimator.bert_base import (
    BERTBaseEstimator,
)


class BERTNER(BERTBaseEstimator):
    def __init__(self, num_entities, bert_config_file=None,
                 init_checkpoint=None, optimizer=None, model_dir=None,
                 dropout=0.1, **bert_overrides):
        def head_fn(seq, pooled, labels, mode, params):
            h = Dropout(dropout)(seq)
            probs = Dense(num_entities, activation="softmax",
                          name="ner_out")(h)
            if mode == "predict" or labels is None:
                return TFEstimatorSpec(mode, predictions=probs)
            return TFEstimatorSpec(mode, predictions=probs,
                                   loss=sparse_ce(probs, labels))

        super().__init__(head_fn, bert_config_file=bert_config_file,
                         init_checkpoint=init_checkpoint,
                         optimizer=optimizer, model_dir=model_dir,
                         **bert_overrides)
