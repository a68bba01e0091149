"""POS/chunk sequence tagger (counterpart of
``analytics_zoo_tpu/tfpark/text/keras/pos_tagging.py``; the reference's
pyzoo/zoo/tfpark/text/keras/pos_tagging.py:21-60, wrapping nlp-architect's
SequenceTagger).

Two outputs: pos tags (B, L, num_pos_labels) and chunk tags
(B, L, num_chunk_labels); a char input too when ``char_vocab_size`` is
given.  The two heads train on a list of labels, their losses summed
(``MultiOutputLoss``).
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


class SequenceTagger(TextKerasModel):
    def __init__(self, num_pos_labels, num_chunk_labels, word_vocab_size,
                 char_vocab_size=None, word_length=12, seq_len=64,
                 feature_size=100, dropout=0.2, classifier="softmax",
                 optimizer=None):
        classifier = classifier.lower()
        assert classifier in ("softmax", "crf"), \
            "classifier should be either softmax or crf"
        words = Input(shape=(seq_len,), name="word_input")
        h = Embedding(word_vocab_size, feature_size)(words)
        inputs = [words]
        if char_vocab_size is not None:
            chars, cf = char_word_features(seq_len, word_length,
                                           char_vocab_size, feature_size)
            inputs.append(chars)
            h = merge([h, cf], mode="concat", concat_axis=-1)
        h = Bidirectional(LSTM(feature_size, return_sequences=True))(h)
        h = Dropout(dropout)(h)
        pos = Dense(num_pos_labels, activation="softmax", name="pos_out")(h)
        chunk = Dense(num_chunk_labels, activation="softmax",
                      name="chunk_out")(h)
        super().__init__(
            Model(inputs if len(inputs) > 1 else inputs[0], [pos, chunk]),
            optimizer,
            losses=["sparse_categorical_crossentropy"] * 2)
