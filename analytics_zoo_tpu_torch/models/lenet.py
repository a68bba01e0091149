"""LeNet-5, the reference's first-run example model (LeNet on MNIST
through the Keras-style ``Sequential``).

Counterpart of ``analytics_zoo_tpu/models/lenet.py``, layer for layer.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Convolution2D,
    Dense,
    Flatten,
    MaxPooling2D,
)


def build_lenet(classes: int = 10, input_shape=(28, 28, 1)) -> Sequential:
    model = Sequential(name="lenet")
    model.add(Convolution2D(6, 5, 5, activation="tanh",
                            border_mode="same", input_shape=input_shape))
    model.add(MaxPooling2D())
    model.add(Convolution2D(16, 5, 5, activation="tanh"))
    model.add(MaxPooling2D())
    model.add(Flatten())
    model.add(Dense(120, activation="tanh"))
    model.add(Dense(84, activation="tanh"))
    model.add(Dense(classes, activation="softmax"))
    return model
