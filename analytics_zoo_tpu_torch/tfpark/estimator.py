"""TFEstimator: spec-driven, bring-your-own-model-function training.

Counterpart of ``analytics_zoo_tpu/tfpark/estimator.py`` (the reference's
pyzoo/zoo/tfpark/estimator.py:84-357).  ``model_fn(features, labels,
mode, params)`` receives symbolic Variables, composes layers and autograd
math, and returns a :class:`TFEstimatorSpec` with ``loss`` and
``predictions`` graph outputs.  The estimator builds a train net (features
and labels in, the per-sample loss out) and a predict net (features in,
predictions out) from that one graph, so they share layer instances, and
trains the first through the port's ``Estimator``: its captured train
step, its fused Adam and its checkpoints.  After every ``train`` the
predict net is handed the trained tensors; its captured ``predict_step``
is dropped when they are new buffers, so a replay never reads stale
weights.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input, Variable
from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import get_metric
from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
    LossFunction,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    get_optimizer,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.topology import Model

TRAIN, EVAL, PREDICT = "train", "eval", "predict"


def ZooOptimizer(optimizer):
    """Reference tfpark.ZooOptimizer wraps a tf.train.Optimizer for the
    distributed engine; here any framework optimizer or name passes
    through."""
    return get_optimizer(optimizer)


def clipped_log(p):
    """log of ``p`` clipped to [1e-7, 1] as ``jnp.clip`` clips (a tie
    splits the gradient evenly)."""
    from analytics_zoo_tpu_torch.pipeline.api.autograd import clip_values

    return torch.log(clip_values(p, 1e-7, 1.0))


def _sparse_ce(p, y):
    logp = clipped_log(p)
    y = y.to(torch.int64).reshape(y.shape[0], -1)
    if y.shape[-1:] != (1,):  # sequence labels: mean over positions
        logp = logp.reshape(tuple(y.shape) + (logp.shape[-1],))
        picked = torch.gather(logp, -1, y[..., None])[..., 0]
        return -torch.mean(picked, dim=-1)
    return -torch.gather(logp, -1, y)[..., 0]


def sparse_ce(probs, labels):
    """Per-sample sparse cross-entropy as a graph op over (probs, integer
    labels) Variables: the log of the probabilities clipped to [1e-7, 1]
    (the reference's tf.nn.sparse_softmax_cross_entropy on the BERT
    heads); sequence labels take the mean over positions."""
    from analytics_zoo_tpu_torch.pipeline.api.autograd import _apply_op

    return _apply_op(_sparse_ce, lambda shapes: (shapes[0][0],), "sparse_ce",
                     probs, labels)


class TFEstimatorSpec:
    """Ops returned by a model_fn (reference estimator.py:76-82)."""

    def __init__(self, mode, predictions=None, loss=None):
        if mode in (TRAIN, EVAL) and loss is None:
            raise ValueError(f"mode {mode!r} requires a loss")
        if mode in (EVAL, PREDICT) and predictions is None:
            raise ValueError(f"mode {mode!r} requires predictions")
        for v, what in ((predictions, "predictions"), (loss, "loss")):
            if v is not None and not _all_variables(v):
                raise TypeError(f"{what} must be symbolic Variable(s) built "
                                "from the features/labels arguments")
        self.mode = mode
        self.predictions = predictions
        self.loss = loss


def _all_variables(v) -> bool:
    vs = v if isinstance(v, (list, tuple)) else [v]
    return all(isinstance(x, Variable) for x in vs)


def _peek_shapes(fs: FeatureSet):
    """(feature_shapes, label_shapes) without the batch dim."""
    batch = next(fs.batches(1, shuffle=False, drop_last=False))
    xs = batch["x"] if isinstance(batch["x"], list) else [batch["x"]]
    ys = batch.get("y")
    ys = [] if ys is None else (ys if isinstance(ys, list) else [ys])
    return ([tuple(a.shape[1:]) for a in xs],
            [tuple(a.shape[1:]) for a in ys])


class TFEstimator:
    """Reference TFEstimator (estimator.py:84): train/evaluate/predict from
    input_fns, spec-driven model building, gradient-clipping setters."""

    def __init__(self, model_fn, optimizer=None, model_dir: str | None = None,
                 config=None, params=None, warm_start_from=None):
        self.model_fn = model_fn
        self.optimizer = get_optimizer(optimizer) if optimizer is not None \
            else None
        self.model_dir = model_dir
        self.config = config
        self.params = params or {}
        self._grad_clip = None
        # built lazily from the first dataset seen
        self._spec = None
        self._train_net = None
        self._pred_net = None
        self._label_count = 0

    # -- gradient clipping (reference estimator.py:168-189) --------------
    def clear_gradient_clipping(self):
        self._grad_clip = None

    def set_constant_gradient_clipping(self, min, max):  # noqa: A002
        self._grad_clip = ("const", float(min), float(max))

    def set_gradient_clipping_by_l2_norm(self, clip_norm):
        self._grad_clip = ("l2norm", float(clip_norm))

    def set_optimizer(self, optimizer):
        self.optimizer = get_optimizer(optimizer)

    # -- graph building ---------------------------------------------------
    def _ensure_built(self, fs: FeatureSet, mode: str):
        """Call model_fn once on symbolic inputs; derive the train and
        predict nets from the same graph so they share layers (the role
        of the reference's TF variable reuse)."""
        if self._spec is not None:
            return
        f_shapes, l_shapes = _peek_shapes(fs)
        features = [Input(shape=s, name=f"feature_{i}")
                    for i, s in enumerate(f_shapes)]
        labels = [Input(shape=s, name=f"label_{i}")
                  for i, s in enumerate(l_shapes)]
        f_arg = features[0] if len(features) == 1 else features
        l_arg = (labels[0] if len(labels) == 1 else labels) if labels \
            else None
        build_mode = mode if (mode == PREDICT or labels) else PREDICT
        spec = self.model_fn(f_arg, l_arg, build_mode, self.params)
        if not isinstance(spec, TFEstimatorSpec):
            raise TypeError("model_fn must return a TFEstimatorSpec")
        self._spec = spec
        self._label_count = len(labels)
        # train net FIRST so canonical layer names are fixed by the full
        # graph; the predict net reuses the already-named layers
        if spec.loss is not None:
            self._train_net = Model(features + labels, spec.loss)
        if spec.predictions is not None:
            self._pred_net = Model(features, spec.predictions)

    def _training_estimator(self):
        from analytics_zoo_tpu_torch.pipeline.estimator import Estimator

        if self.optimizer is None:
            raise ValueError("no optimizer set; pass optimizer= or call "
                             "set_optimizer")
        # the graph already computes the loss; the training loss fn just
        # averages the graph output
        passthrough = LossFunction(lambda y_true, y_pred: y_pred,
                                   "model_fn_loss")
        return Estimator(self._train_net, optimizer=self.optimizer,
                         loss=passthrough, grad_clip=self._grad_clip,
                         model_dir=self.model_dir)

    @staticmethod
    def _to_feature_set(data) -> FeatureSet:
        if isinstance(data, FeatureSet):
            return data
        if isinstance(data, tuple):
            return FeatureSet.of(*data)
        return FeatureSet.of(data)

    # -- the tf.estimator-style entry points ------------------------------
    def train(self, input_fn, steps: int | None = None,
              batch_size: int = 32) -> "TFEstimator":
        """Reference estimator.py:194-251: train until ``steps`` iterations
        (or one epoch if None).  As in the JAX package the end trigger is
        checked at epoch boundaries, so ``steps`` inside an epoch trains
        that epoch to its end."""
        from analytics_zoo_tpu_torch.common.triggers import (
            MaxEpoch,
            MaxIteration,
        )

        fs = self._to_feature_set(input_fn())
        self._ensure_built(fs, TRAIN)
        if self._train_net is None:
            raise ValueError("model_fn returned no loss; cannot train")
        # re-wrap: features+labels all become model *inputs* of the loss net
        merged = _MergedFeatureSet(fs)
        est = self._training_estimator()
        end = MaxIteration(steps) if steps is not None else MaxEpoch(1)
        est.train(merged, batch_size=batch_size, end_trigger=end)
        self._estimator = est
        self._sync_params_to_pred()
        return self

    @property
    def _trained(self) -> bool:
        return self._train_net is not None and \
            self._train_net.params is not None

    def _sync_params_to_pred(self):
        """Hand the predict net the train net's tensors for the layers they
        share (layers only on the predictions path keep theirs); a cached
        capture of the predict step is dropped when a tensor changed."""
        if self._pred_net is None or not self._trained:
            return
        pred = self._pred_net
        if pred.params is None:
            train = self._train_net
            pred.build_params(device=train.device,
                              given=(train.params, train.state))
        params = {**pred.params,
                  **{k: v for k, v in self._train_net.params.items()
                     if k in pred.params}}
        state = {**pred.state,
                 **{k: v for k, v in self._train_net.state.items()
                    if k in pred.state}}
        if _same_tensors(params, pred.params) and \
                _same_tensors(state, pred.state):
            return
        pred.params, pred.state = params, state
        pred._predict_fn = None  # its captures read the old buffers

    def evaluate(self, input_fn, eval_methods, steps=None,
                 checkpoint_path=None) -> dict:
        """Reference estimator.py:253-313: dict of metric -> value."""
        fs = self._to_feature_set(input_fn())
        self._ensure_built(fs, EVAL)
        if self._pred_net is None:
            raise ValueError("model_fn returned no predictions")
        preds, labels = self._forward_all(fs)
        out = {}
        for name in eval_methods:
            metric = get_metric(name)
            out[name] = metric.finalize(metric.batch_stats(
                _host_tensors(labels), _host_tensors(preds)))
        if self._trained:
            losses = self._loss_all(fs)
            out["loss"] = float(np.mean(losses))
        return out

    def predict(self, input_fn, checkpoint_path=None,
                batch_size: int = 32) -> np.ndarray:
        """Reference estimator.py:315+."""
        fs = self._to_feature_set(input_fn())
        self._ensure_built(fs, PREDICT)
        if self._pred_net is None:
            raise ValueError("model_fn returned no predictions")
        self._sync_params_to_pred()
        xs = _stack_all(fs, labels=False)
        return self._pred_net.predict(
            xs[0] if len(xs) == 1 else xs, batch_size=batch_size)

    # -- helpers -----------------------------------------------------------
    def _forward_all(self, fs: FeatureSet):
        self._sync_params_to_pred()
        xs = _stack_all(fs, labels=False)
        ys = _stack_all(fs, labels=True)
        preds = self._pred_net.predict(xs[0] if len(xs) == 1 else xs)
        return preds, (ys[0] if len(ys) == 1 else ys)

    def _loss_all(self, fs: FeatureSet):
        # the loss output may be scalar per batch; run batch-wise forwards
        from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
            _to_device,
        )

        net = self._train_net
        net.build_params()
        losses = []
        for batch in _MergedFeatureSet(fs).batches(256, shuffle=False,
                                                   drop_last=False):
            xs = _to_device({"x": batch["x"]}, net.device)["x"]
            with torch.no_grad():
                out, _ = net.forward(net.params, xs, state=net.state,
                                     training=False)
            losses.append(float(out.float().mean()))
        return losses


def _same_tensors(a: dict, b: dict) -> bool:
    from analytics_zoo_tpu_torch.common.utils import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x is y for x, y in zip(la, lb))


def _host_tensors(a):
    if isinstance(a, list):
        return [torch.from_numpy(np.asarray(v)) for v in a]
    return torch.from_numpy(np.asarray(a))


def _stack_all(fs: FeatureSet, labels: bool) -> list:
    """Materialize a FeatureSet side as full arrays (eval/predict path)."""
    chunks = []
    for batch in fs.batches(1024, shuffle=False, drop_last=False):
        part = batch.get("y") if labels else batch["x"]
        if part is None:
            return []
        chunks.append(part if isinstance(part, list) else [part])
    return [np.concatenate([c[i] for c in chunks])
            for i in range(len(chunks[0]))]


class _MergedFeatureSet(FeatureSet):
    """View of a FeatureSet where labels are appended to the features (the
    loss net takes features+labels as inputs and outputs the loss)."""

    def __init__(self, base: FeatureSet):
        self.base = base

    @property
    def num_samples(self):
        return self.base.num_samples

    def batches(self, *args, **kwargs):
        for batch in self.base.batches(*args, **kwargs):
            xs = batch["x"] if isinstance(batch["x"], list) else [batch["x"]]
            ys = batch.get("y")
            ys = [] if ys is None else (
                ys if isinstance(ys, list) else [ys])
            merged = {"x": list(xs) + list(ys)}
            if "w" in batch:
                merged["w"] = batch["w"]
            if "n_valid" in batch:
                merged["n_valid"] = batch["n_valid"]
            yield merged
