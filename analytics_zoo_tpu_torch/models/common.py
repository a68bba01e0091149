"""The zoo models' common base and ranking metrics.

Counterpart of ``analytics_zoo_tpu/models/common.py``: :class:`ZooModel`
wraps a built ``KerasNet`` and forwards its compile/fit/evaluate/predict/
save surface; :class:`Ranker` holds the ranking metrics (NDCG@k, recall
in the top k, mean average precision) over grouped relevance lists, in
numpy as the reference computes them.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api.keras.topology import KerasNet


class ZooModel:
    """Base for zoo models: subclasses implement ``build_model() ->
    KerasNet`` and may add helpers of their domain (``recommend_for_user``
    and the like)."""

    def __init__(self):
        self.model: KerasNet = self.build_model()

    def build_model(self) -> KerasNet:
        raise NotImplementedError

    # -- forwarded surface -------------------------------------------------
    def compile(self, *args, **kwargs):
        self.model.compile(*args, **kwargs)
        return self

    def fit(self, *args, **kwargs):
        self.model.fit(*args, **kwargs)
        return self

    def evaluate(self, *args, **kwargs):
        return self.model.evaluate(*args, **kwargs)

    def predict(self, *args, **kwargs):
        return self.model.predict(*args, **kwargs)

    def predict_classes(self, *args, **kwargs):
        return self.model.predict_classes(*args, **kwargs)

    def set_tensorboard(self, *args, **kwargs):
        self.model.set_tensorboard(*args, **kwargs)

    def set_checkpoint(self, *args, **kwargs):
        self.model.set_checkpoint(*args, **kwargs)

    def summary(self):
        return self.model.summary()

    @property
    def params(self):
        return self.model.params

    def save_model(self, path, over_write=True):
        """The net through ``KerasNet.save`` at ``path``, and beside it
        (``path + ".zoo_meta"``) the wrapper's class and configuration, so
        :meth:`load_model` restores the subclass without running
        ``build_model`` again (a live net in the configuration is stored as
        None)."""
        self.model.save(path, over_write=over_write)
        with open(path + ".zoo_meta", "wb") as f:
            cfg = {k: (None if isinstance(v, KerasNet) else v)
                   for k, v in self.__dict__.items() if k != "model"}
            pickle.dump({"cls": type(self), "cfg": cfg}, f)

    @staticmethod
    def load_model(path, device=None):
        """A model written by :meth:`save_model` (or a bare net written by
        ``KerasNet.save``), onto ``device`` (default: the context's).  Both
        files go through the port's allow-listed unpickler, and the
        wrapper's class must be one of the port's zoo models: a file the
        JAX package saved names JAX classes and is refused."""
        from analytics_zoo_tpu_torch.common.safe_pickle import safe_load

        net = KerasNet.load(path, device=device)
        meta = path + ".zoo_meta"
        if not os.path.exists(meta):
            return net
        with open(meta, "rb") as f:
            blob = safe_load(f)
        cls = blob["cls"]
        if not (isinstance(cls, type) and issubclass(cls, ZooModel)):
            raise ValueError(f"{meta} names {cls!r}, not a zoo model class")
        obj = cls.__new__(cls)
        obj.__dict__.update(blob["cfg"])
        obj.model = net
        return obj


class Ranker:
    """Ranking evaluation over grouped (query, candidates) relevance
    lists: the reference's ``evaluateNDCG`` and ``evaluateMAP``."""

    @staticmethod
    def ndcg(y_true_groups, y_score_groups, k: int = 10) -> float:
        """Mean NDCG@k over the groups."""
        scores = []
        for rel, pred in zip(y_true_groups, y_score_groups):
            rel = np.asarray(rel, dtype=np.float64)
            pred = np.asarray(pred, dtype=np.float64)
            order = np.argsort(-pred)[:k]
            gains = (2.0 ** rel[order] - 1.0) / np.log2(
                np.arange(2, len(order) + 2))
            ideal_order = np.argsort(-rel)[:k]
            ideal = (2.0 ** rel[ideal_order] - 1.0) / np.log2(
                np.arange(2, len(ideal_order) + 2))
            denom = ideal.sum()
            scores.append(gains.sum() / denom if denom > 0 else 0.0)
        return float(np.mean(scores)) if scores else 0.0

    @staticmethod
    def recall_top_k(y_true_groups, y_score_groups, k: int = 10) -> float:
        """Mean fraction of a group's relevant items in its top k (groups
        with none relevant left out)."""
        scores = []
        for rel, pred in zip(y_true_groups, y_score_groups):
            rel = np.asarray(rel) > 0
            if rel.sum() == 0:
                continue
            order = np.argsort(-np.asarray(pred))[:k]
            scores.append(rel[order].sum() / rel.sum())
        return float(np.mean(scores)) if scores else 0.0

    @staticmethod
    def mean_average_precision(y_true_groups, y_score_groups,
                               threshold: float = 0.0) -> float:
        """Mean average precision, an item relevant above ``threshold``."""
        aps = []
        for rel, pred in zip(y_true_groups, y_score_groups):
            rel = np.asarray(rel) > threshold
            order = np.argsort(-np.asarray(pred))
            rel_sorted = rel[order]
            if rel_sorted.sum() == 0:
                continue
            precision = np.cumsum(rel_sorted) / np.arange(
                1, len(rel_sorted) + 1)
            aps.append((precision * rel_sorted).sum() / rel_sorted.sum())
        return float(np.mean(aps)) if aps else 0.0
