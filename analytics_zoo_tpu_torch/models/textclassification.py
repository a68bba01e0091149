"""Text classification: an embedding, a CNN, LSTM or GRU encoder and a
dense softmax head.

Counterpart of ``analytics_zoo_tpu/models/textclassification.py``, layer
for layer and name for name.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    GRU,
    LSTM,
    Convolution1D,
    Dense,
    Dropout,
    Embedding,
    GlobalMaxPooling1D,
)


class TextClassifier(ZooModel):
    """``TextClassifier(class_num, token_length, sequence_length, encoder,
    encoder_output_dim, vocab_size, embedding_weights, train_embed)``,
    ``encoder`` one of ``"cnn"``, ``"lstm"``, ``"gru"``.  With
    ``embedding_weights`` and ``train_embed=False`` the table is frozen and
    lives in the model's state."""

    def __init__(self, class_num, token_length, sequence_length=500,
                 encoder="cnn", encoder_output_dim=256, vocab_size=20000,
                 embedding_weights=None, train_embed=True):
        self.class_num = int(class_num)
        self.token_length = int(token_length)
        self.sequence_length = int(sequence_length)
        self.encoder = encoder.lower()
        self.encoder_output_dim = int(encoder_output_dim)
        self.vocab_size = int(vocab_size)
        self.embedding_weights = embedding_weights
        self.train_embed = train_embed
        super().__init__()

    def build_model(self):
        model = Sequential(name="text_classifier")
        model.add(Embedding(self.vocab_size, self.token_length,
                            weights=self.embedding_weights,
                            trainable=self.train_embed,
                            input_shape=(self.sequence_length,),
                            name="embedding"))
        if self.encoder == "cnn":
            model.add(Convolution1D(self.encoder_output_dim, 5,
                                    activation="relu", name="conv"))
            model.add(GlobalMaxPooling1D())
        elif self.encoder == "lstm":
            model.add(LSTM(self.encoder_output_dim, name="lstm"))
        elif self.encoder == "gru":
            model.add(GRU(self.encoder_output_dim, name="gru"))
        else:
            raise ValueError(f"unknown encoder {self.encoder!r}")
        model.add(Dropout(0.2))
        model.add(Dense(128, activation="relu", name="fc1"))
        model.add(Dense(self.class_num, activation="softmax", name="head"))
        return model
