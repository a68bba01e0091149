"""TextKerasModel base (counterpart of
``analytics_zoo_tpu/tfpark/text/keras/text_model.py``; the reference's
pyzoo/zoo/tfpark/text/keras/text_model.py:21-35).

Each text model builds the port's own functional graph, and this base
wires multi-output training: the per-head losses are summed
(``MultiOutputLoss``, per sample, so the fit's mean and the evaluate's
masked sums work as for one head), as a tf.keras multi-output compile
does.
"""

from __future__ import annotations

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
    LossFunction,
    get_loss,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import get_optimizer
from analytics_zoo_tpu_torch.tfpark.model import KerasModel


class MultiOutputLoss(LossFunction):
    """Sum of per-head losses for multi-output nets (y_true/y_pred lists)."""

    def __init__(self, losses, weights=None):
        self.losses = [get_loss(l) for l in losses]
        self.weights = list(weights) if weights is not None \
            else [1.0] * len(self.losses)
        super().__init__(None, "multi_output")

    def __call__(self, y_true, y_pred):
        total = 0.0
        for loss, w, yt, yp in zip(self.losses, self.weights, y_true,
                                   y_pred):
            total = total + w * loss(yt, yp)
        return total

class TextKerasModel(KerasModel):
    """Base: compile with the right (possibly multi-head) loss, keep the
    reference's fit/evaluate/predict + save/load surface."""

    def __init__(self, model, optimizer=None,
                 losses=("sparse_categorical_crossentropy",)):
        losses = [losses] if isinstance(losses, str) else list(losses)
        loss = MultiOutputLoss(losses) if len(losses) > 1 else \
            get_loss(losses[0])
        model.compile(optimizer=get_optimizer(optimizer or "adam"),
                      loss=loss, metrics=None)
        super().__init__(model)

    def save_model(self, path, overwrite=True):
        self.model.save(path, over_write=overwrite)

    @classmethod
    def load_model(cls, path):
        from analytics_zoo_tpu_torch.pipeline.api.keras.topology import KerasNet

        obj = cls.__new__(cls)
        KerasModel.__init__(obj, KerasNet.load(path))
        return obj

    def predict_classes(self, x, batch_size=32) -> np.ndarray:
        probs = self.model.predict(x, batch_size=batch_size)
        if isinstance(probs, list):
            return [np.argmax(np.asarray(p), -1) for p in probs]
        return np.argmax(probs, -1)
