"""NER model (counterpart of ``analytics_zoo_tpu/tfpark/text/keras/ner.py``;
the reference's pyzoo/zoo/tfpark/text/keras/ner.py:21-70, which wraps
nlp-architect's NERCRF: word and char inputs, a Bi-LSTM tagger).

Inputs: word indices (B, L) and char indices (B, L, word_length).
Output: entity tag distribution (B, L, num_entities).

As in the JAX package, a word's char feature is the mean of its
characters' embeddings (``AutoGrad.mean`` over the word axis, a node of
the graph), not a per-word char Bi-LSTM; the tagger Bi-LSTMs stay, and
the CRF output layer is a per-token softmax (``crf_mode`` is accepted and
ignored).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.autograd import AutoGrad
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Bidirectional,
    Dense,
    Dropout,
    Embedding,
    LSTM,
    Reshape,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.topology import Model, merge
from analytics_zoo_tpu_torch.tfpark.text.keras.text_model import TextKerasModel


def char_word_features(seq_len, word_length, char_vocab_size, char_emb_dim):
    """char ids (B, L, W) -> per-word char feature (B, L, char_emb_dim)."""
    chars = Input(shape=(seq_len, word_length), name="char_input")
    flat = Reshape((seq_len * word_length,))(chars)
    ce = Embedding(char_vocab_size, char_emb_dim)(flat)
    ce = Reshape((seq_len, word_length, char_emb_dim))(ce)
    pooled = AutoGrad.mean(ce, axis=2)
    return chars, pooled


class NER(TextKerasModel):
    def __init__(self, num_entities, word_vocab_size, char_vocab_size,
                 word_length=12, seq_len=64, word_emb_dim=100,
                 char_emb_dim=30, tagger_lstm_dim=100, dropout=0.5,
                 crf_mode="reg", optimizer=None):
        self.num_entities = int(num_entities)
        words = Input(shape=(seq_len,), name="word_input")
        we = Embedding(word_vocab_size, word_emb_dim)(words)
        chars, cf = char_word_features(seq_len, word_length, char_vocab_size,
                                       char_emb_dim)
        h = merge([we, cf], mode="concat", concat_axis=-1)
        h = Bidirectional(LSTM(tagger_lstm_dim, return_sequences=True))(h)
        h = Dropout(dropout)(h)
        h = Bidirectional(LSTM(tagger_lstm_dim, return_sequences=True))(h)
        out = Dense(num_entities, activation="softmax")(h)
        super().__init__(Model([words, chars], out), optimizer,
                         losses="sparse_categorical_crossentropy")
