"""The tfpark text taggers: NER, SequenceTagger, IntentEntity."""

from .intent_extraction import IntentEntity
from .ner import NER
from .pos_tagging import SequenceTagger
from .text_model import TextKerasModel

__all__ = ["TextKerasModel", "NER", "SequenceTagger", "IntentEntity"]
