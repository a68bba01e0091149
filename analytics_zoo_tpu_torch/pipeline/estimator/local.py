"""LocalEstimator — a trainer without the Estimator's fit machinery.

Counterpart of ``analytics_zoo_tpu/pipeline/estimator/local.py`` (reference
zoo/.../pipeline/estimator/LocalEstimator.scala:39-211): ``fit`` over
``(x, y)`` arrays for ``epochs`` epochs from epoch 0, a fresh optimizer
state each fit, the step's randomness ``fold_in(PRNGKey(seed), it)`` (the
port's ``step_generator(seed, it)``), and ``history`` the last loss of
each epoch.  K-step dispatch (``steps_per_dispatch``, default
``ZOO_STEPS_PER_DISPATCH``) runs K steps a dispatch through
``compile_step``, captured into a CUDA graph on the card, as the
estimator's fit does, with the same trajectory as K=1 (an epoch's tail
runs the K=1 step).  ``evaluate`` is the loss over every record and each
metric's ``finalize``.  The step is the estimator's (frozen layers are
masked, as there).
"""

from __future__ import annotations

import os

import torch

from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.parallel.plan import resolve_plan
from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import get_metric
from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import get_loss
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    get_optimizer,
)
from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
    Estimator,
    _chunks_dynamic,
    _to_device,
)


class LocalEstimator:
    def __init__(self, model, criterion, optimizer, metrics=None):
        self.model = model
        self.loss = get_loss(criterion)
        self.optimizer = get_optimizer(optimizer)
        self.metrics = [get_metric(m) for m in (metrics or [])]
        self._est = Estimator(model, optimizer=self.optimizer,
                              loss=self.loss, metrics=self.metrics)
        self.history: list = []

    def fit(self, x, y, validation_data=None, batch_size=32, epochs=1,
            seed=0, steps_per_dispatch=None):
        """``epochs`` epochs over (x, y); ``steps_per_dispatch`` K (default
        ``ZOO_STEPS_PER_DISPATCH``, then 1) train steps a dispatch, with the
        K=1 trajectory."""
        if steps_per_dispatch is None:
            steps_per_dispatch = int(
                os.environ.get("ZOO_STEPS_PER_DISPATCH", "1"))
        k = int(steps_per_dispatch)
        if k < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        est = self._est
        plan = resolve_plan(None)
        params, state = self.model.build_params()
        device = self.model.device
        params, opt_state, state = (
            tree_map(torch.clone, params),
            self.optimizer.in_layout(self.optimizer.init(params)),
            tree_map(torch.clone, state))
        fs = FeatureSet.of(x, y)
        casts = est.compute_casts(plan, params)
        it = 0
        history = []
        for epoch in range(epochs):
            last = None
            for chunk in _chunks_dynamic(
                    fs.batches(batch_size, shuffle=True, seed=seed,
                               epoch=epoch), lambda: k):
                n = len(chunk)
                params, opt_state, state, out = est._train_step_for(
                    n, plan)(params, opt_state, state,
                             est._keys(n, device, seed, it),
                             [_to_device(b, device) for b in chunk], casts)
                last = out[n - 1]
                it += n
            history.append(float(last) if last is not None else None)
        self.model.params, self.model.state = params, state
        self.model._predict_fn = None  # the trained parameters are new
        self.history = history
        return self

    def evaluate(self, x, y, batch_size=32):
        """``{"loss": ..., <metric>: ...}`` over every record of (x, y)."""
        return self._est.evaluate(FeatureSet.of(x, y), batch_size)
