"""BERTClassifier (counterpart of
``analytics_zoo_tpu/tfpark/text/estimator/bert_classifier.py``; the
reference's pyzoo/zoo/tfpark/text/estimator/bert_classifier.py:20-90):
pooled output -> dropout -> dense softmax."""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense, Dropout
from analytics_zoo_tpu_torch.tfpark.estimator import (  # noqa: F401
    TFEstimatorSpec,
    sparse_ce,
)
from analytics_zoo_tpu_torch.tfpark.text.estimator.bert_base import (
    BERTBaseEstimator,
)


class BERTClassifier(BERTBaseEstimator):
    def __init__(self, num_classes, bert_config_file=None,
                 init_checkpoint=None, optimizer=None, model_dir=None,
                 dropout=0.1, **bert_overrides):
        def head_fn(seq, pooled, labels, mode, params):
            h = Dropout(dropout)(pooled)
            probs = Dense(num_classes, activation="softmax",
                          name="classifier_out")(h)
            if mode == "predict" or labels is None:
                return TFEstimatorSpec(mode, predictions=probs)
            loss = sparse_ce(probs, labels)
            return TFEstimatorSpec(mode, predictions=probs, loss=loss)

        super().__init__(head_fn, bert_config_file=bert_config_file,
                         init_checkpoint=init_checkpoint,
                         optimizer=optimizer, model_dir=model_dir,
                         **bert_overrides)
