"""tfpark.KerasModel (counterpart of ``analytics_zoo_tpu/tfpark/model.py``;
the reference's pyzoo/zoo/tfpark/model.py:30-315).

The reference wraps a compiled tf.keras model; here, as in the JAX
package, the wrapped model is the port's own ``KerasNet``, and ``fit``,
``evaluate`` and ``predict`` go through its captured steps.  The wrapper
keeps the tf.keras-flavoured argument names and the checkpoint-directory
convention (``model_dir``).
"""

from __future__ import annotations

import numpy as np


class KerasModel:
    """tf.keras-style facade over a compiled KerasNet."""

    def __init__(self, model, model_dir: str | None = None):
        self.model = model
        self.model_dir = model_dir
        if model_dir:
            model.set_checkpoint(model_dir)

    def fit(self, x=None, y=None, batch_size=32, epochs=1,
            validation_data=None, distributed=True, **kwargs):
        """Reference model.py:90-161 (``fit`` -> TFOptimizer.optimize)."""
        return self.model.fit(x, y, batch_size=batch_size, nb_epoch=epochs,
                              validation_data=validation_data, **kwargs)

    def evaluate(self, x=None, y=None, batch_per_thread=None,
                 batch_size=32, distributed=True):
        """Reference model.py:220 (``evaluate`` -> TFNet)."""
        return self.model.evaluate(x, y,
                                   batch_size=batch_per_thread or batch_size)

    def predict(self, x, batch_per_thread=None, batch_size=32,
                distributed=True):
        """Reference model.py:294 (``predict`` -> TFPredictor)."""
        return self.model.predict(x, batch_size=batch_per_thread
                                  or batch_size)

    def get_weights(self):
        return self.model.get_weights()

    def set_weights(self, weights):
        self.model.set_weights(weights)

    def save_weights(self, filepath, overwrite=True):
        self.model.save_weights(filepath, over_write=overwrite)

    def load_weights(self, filepath, by_name=False):
        self.model.load_weights(filepath)

    def save_model(self, path, overwrite=True):
        self.model.save(path, over_write=overwrite)

    @staticmethod
    def load_model(path) -> "KerasModel":
        from analytics_zoo_tpu_torch.pipeline.api.keras.topology import (
            KerasNet,
        )

        return KerasModel(KerasNet.load(path))

    def predict_classes(self, x, batch_size=32) -> np.ndarray:
        return self.model.predict_classes(x, batch_size=batch_size)
