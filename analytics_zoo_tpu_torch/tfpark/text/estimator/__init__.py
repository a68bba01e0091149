"""tfpark's BERT estimators (counterpart of
``analytics_zoo_tpu/tfpark/text/estimator/``)."""

from .bert_base import BERTBaseEstimator, bert_input_fn
from .bert_classifier import BERTClassifier
from .bert_ner import BERTNER
from .bert_squad import BERTSquad

__all__ = ["BERTBaseEstimator", "bert_input_fn", "BERTClassifier",
           "BERTNER", "BERTSquad"]
