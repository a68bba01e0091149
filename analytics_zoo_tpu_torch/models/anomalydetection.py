"""Anomaly detection: stacked LSTMs regressing the next value, and the
unroll and threshold utilities around them.

Counterpart of ``analytics_zoo_tpu/models/anomalydetection.py``.
"""

from __future__ import annotations

import numpy as np

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    LSTM,
    Dense,
    Dropout,
)


class AnomalyDetector(ZooModel):
    """Stacked LSTMs (each but the last returning sequences), each followed
    by its dropout, then a linear head predicting the next value:
    ``AnomalyDetector(feature_shape, hidden_layers, dropouts)``."""

    def __init__(self, feature_shape, hidden_layers=(8, 32, 15),
                 dropouts=(0.2, 0.2, 0.2)):
        self.feature_shape = tuple(feature_shape)
        self.hidden_layers = tuple(hidden_layers)
        self.dropouts = tuple(dropouts)
        if len(self.hidden_layers) != len(self.dropouts):
            raise ValueError("one dropout for each hidden layer")
        super().__init__()

    def build_model(self):
        model = Sequential(name="anomaly_detector")
        for i, (width, drop) in enumerate(
                zip(self.hidden_layers, self.dropouts)):
            last = i == len(self.hidden_layers) - 1
            kwargs = dict(input_shape=self.feature_shape) if i == 0 else {}
            model.add(LSTM(width, return_sequences=not last,
                           name=f"lstm_{i}", **kwargs))
            model.add(Dropout(drop))
        model.add(Dense(1, name="head"))
        return model

    @staticmethod
    def unroll(data, unroll_length: int):
        """Sliding windows: an (N, F) series (or (N,)) -> x (M, unroll, F)
        and y (M,), the next value of the first feature."""
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data[:, None]
        n = len(data) - unroll_length
        x = np.stack([data[i:i + unroll_length] for i in range(n)])
        y = data[unroll_length:, 0]
        return x, y

    @staticmethod
    def detect_anomalies(y_true, y_pred, anomaly_size: int = 5):
        """(truth, prediction, is_anomaly) per point: the ``anomaly_size``
        largest absolute errors (ties at the threshold included) are
        anomalies."""
        y_true = np.asarray(y_true).reshape(-1)
        y_pred = np.asarray(y_pred).reshape(-1)
        err = np.abs(y_true - y_pred)
        threshold = np.sort(err)[-min(anomaly_size, len(err))]
        flags = err >= threshold
        return [(float(t), float(p), bool(a))
                for t, p, a in zip(y_true, y_pred, flags)]
