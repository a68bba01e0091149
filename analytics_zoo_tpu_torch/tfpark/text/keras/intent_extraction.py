"""Joint intent and entity model (counterpart of
``analytics_zoo_tpu/tfpark/text/keras/intent_extraction.py``; the
reference's pyzoo/zoo/tfpark/text/keras/intent_extraction.py:21-70,
wrapping nlp-architect's MultiTaskIntentModel).

Inputs: word indices (B, L), char indices (B, L, word_length).
Outputs: intent distribution (B, num_intents) and entity tags
(B, L, num_entities), trained on a list of two labels with their losses
summed (``MultiOutputLoss``).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Bidirectional,
    Dense,
    Dropout,
    Embedding,
    LSTM,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.topology import Model, merge
from analytics_zoo_tpu_torch.tfpark.text.keras.ner import char_word_features
from analytics_zoo_tpu_torch.tfpark.text.keras.text_model import TextKerasModel


class IntentEntity(TextKerasModel):
    def __init__(self, num_intents, num_entities, word_vocab_size,
                 char_vocab_size, word_length=12, seq_len=64,
                 word_emb_dim=100, char_emb_dim=30, char_lstm_dim=30,
                 tagger_lstm_dim=100, dropout=0.2, optimizer=None):
        words = Input(shape=(seq_len,), name="word_input")
        we = Embedding(word_vocab_size, word_emb_dim)(words)
        chars, cf = char_word_features(seq_len, word_length, char_vocab_size,
                                       char_emb_dim)
        h = merge([we, cf], mode="concat", concat_axis=-1)
        shared = Bidirectional(LSTM(tagger_lstm_dim,
                                    return_sequences=True))(h)
        shared = Dropout(dropout)(shared)
        # intent head: final-state summary of the shared encoding
        intent_enc = Bidirectional(LSTM(tagger_lstm_dim))(shared)
        intent = Dense(num_intents, activation="softmax",
                       name="intent_out")(intent_enc)
        # entity head: per-token tagger
        tagged = Bidirectional(LSTM(tagger_lstm_dim,
                                    return_sequences=True))(shared)
        entities = Dense(num_entities, activation="softmax",
                         name="entity_out")(tagged)
        super().__init__(Model([words, chars], [intent, entities]),
                         optimizer,
                         losses=["sparse_categorical_crossentropy"] * 2)
