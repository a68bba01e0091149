"""Estimator — the training loop (single-device subset).

Counterpart of ``analytics_zoo_tpu/pipeline/estimator/estimator.py``.  One
train step is the reference's ``one_step`` (estimator.py:936-1007) in eager
PyTorch: the forward with ``training=True`` and the step's generator, the
f32 loss mean, the backward (``torch.autograd.grad``), frozen-layer
masking, gradient clipping, the optimizer update and
``optax.apply_updates``.  The step's generator is
``step_generator(seed, global_step)`` on the model's device, the
counterpart of ``fold_in(PRNGKey(seed), step)``.

On the card the three training scopes take their kernels, as the JAX
package does under ``ZOO_USE_PALLAS=1``: attention (flash forward and
backward, where ``flash_eligible`` holds), ``loss.softmax_xent`` (2-D
logits with 1-D labels) and ``optimizer.adam`` (f32 leaves of at least 128
elements).  The train step runs under a plan
(``Estimator(plan=)``/``train(plan=)``, default ``dp``) through
``parallel.plan.compile_step``, as in the reference, so a plan's
``kernel_rules`` can opt a scope out with ``"xla"`` (its plain PyTorch
path).  A plan whose ``dtype_rules`` carry a compute role (bf16, f16, or
int8, which the reference trains in bf16) raises: the port trains in f32
only (ROADMAP queue 1 item 22).

Batches come from ``FeatureSet.batches`` with the reference's seeded
shuffle, so both packages see the same batches in the same order.
``history`` holds one record per epoch, as in the reference;
``loss_log`` holds every step's ``(iteration, loss)``, the values the
reference writes as TensorBoard ``Loss`` scalars.  Not ported yet (ROADMAP
queue 1, item 6): sharded plans, fused multi-step dispatch, checkpoints
and resume, the prefetch and autotune planes, TensorBoard and metrics.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import (
    cast_floats,
    get_zoo_context,
    step_generator,
)
from analytics_zoo_tpu_torch.common.triggers import (
    EveryEpoch,
    MaxEpoch,
    TrainingState,
    ZooTrigger,
)
from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.parallel.plan import (
    COMPUTE_ROLES,
    compile_step,
    resolve_plan,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    _unflatten,
    apply_updates,
)

logger = logging.getLogger("analytics_zoo_tpu_torch")


def _normalize_grad_clip(grad_clip):
    """``None | ("l2norm", max) | ("const", lo, hi)``; a bare scalar is a
    max-norm.  Validated here so a bad spec fails before training."""
    if grad_clip is None:
        return None
    if not isinstance(grad_clip, (tuple, list)):
        return ("l2norm", float(grad_clip))
    t = tuple(grad_clip)
    if len(t) == 2 and t[0] == "l2norm":
        return ("l2norm", float(t[1]))
    if len(t) == 3 and t[0] == "const":
        return ("const", float(t[1]), float(t[2]))
    raise ValueError(f"unknown grad clip {grad_clip!r}")


def _clip_grads(grads, grad_clip):
    """The reference's ``_clip_grads``: elementwise clamp, or scale every
    leaf by min(1, max_norm / (global L2 norm + 1e-12))."""
    grad_clip = _normalize_grad_clip(grad_clip)
    if grad_clip is None:
        return grads
    if grad_clip[0] == "const":
        _, lo, hi = grad_clip
        return tree_map(lambda g: torch.clamp(g, lo, hi), grads)
    _, max_norm = grad_clip
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _tensor(a, device):
    """A batch array as a tensor on ``device``; float64 becomes float32, as
    JAX's default (x64 off) makes it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def _to_device(batch, device):
    out = {}
    for k, v in batch.items():
        if k == "n_valid":
            out[k] = int(v)
        elif isinstance(v, list):
            out[k] = [_tensor(a, device) for a in v]
        else:
            out[k] = _tensor(v, device)
    return out


class Estimator:
    """Train and evaluate a KerasNet on its device."""

    def __init__(self, model, optimizer=None, loss=None, metrics=None,
                 grad_clip=None, ctx=None, plan=None):
        self.model = model
        # a ShardingPlan or a plan name; None is "dp".  train(plan=)
        # overrides it per fit.
        self.plan = plan
        self.optimizer = optimizer
        self.loss = loss
        self.metrics = list(metrics or [])
        self.grad_clip = _normalize_grad_clip(grad_clip)
        self.ctx = ctx or get_zoo_context()
        self.global_step = 0
        self.epoch = 1
        self.history: list[dict] = []
        self.loss_log: list[tuple[int, float]] = []
        self._opt_state = None  # persists across fit() calls

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def loss_and_grads(self, params, state, batch, rng):
        """(loss, grads, new_state) of one training forward and backward;
        ``batch`` holds tensors on the model's device, ``rng`` is the step's
        generator.  Integer leaves get zero gradients."""
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in tree_leaves(params)]
        p = _unflatten(params, leaves)
        dtype = self.ctx.compute_dtype
        with torch.enable_grad():
            preds, new_state = self.model.forward(
                cast_floats(p, dtype), cast_floats(batch["x"], dtype),
                state=state, training=True, rng=rng)
            preds = cast_floats(preds, torch.float32)
            loss = self.loss.mean(batch.get("y"), preds, batch.get("w"))
        wrt = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for t in leaves:
            g = next(got) if t.requires_grad else None
            grads.append(torch.zeros_like(t) if g is None else g)
        new_state = tree_map(lambda s: s.detach(), new_state or {})
        return loss.detach(), _unflatten(params, grads), new_state

    def _mask_frozen(self, tree):
        frozen = getattr(self.model, "_frozen", ()) or ()
        if not frozen:
            return tree
        return {k: tree_map(torch.zeros_like, v) if k in frozen else v
                for k, v in tree.items()}

    def train_step(self, params, opt_state, state, rng, batch):
        """One optimizer step: (params, opt_state, state, loss)."""
        loss, grads, state = self.loss_and_grads(params, state, batch, rng)
        # frozen layers: grads AND updates masked to zero (the reference's
        # transfer-learning contract)
        grads = _clip_grads(self._mask_frozen(grads), self.grad_clip)
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(grads, opt_state,
                                                       params)
            params = apply_updates(params, self._mask_frozen(updates))
        return params, opt_state, state, loss

    # ------------------------------------------------------------------
    # train / evaluate
    # ------------------------------------------------------------------
    def _resolve_plan(self, plan=None):
        """The plan of this fit (``plan`` over the estimator's), refused if
        its dtype rules would change the training compute dtype."""
        plan = resolve_plan(plan if plan is not None else self.plan)
        compute = sorted({role for _, role in plan.dtype_rules
                          if role in COMPUTE_ROLES})
        if compute:
            raise NotImplementedError(
                f"plan {plan.name!r} computes in {compute}: mixed-precision "
                "training is not ported yet (ROADMAP queue 1 item 22); the "
                "port trains in f32 only")
        return plan

    def train(self, train_set: FeatureSet, batch_size: int = 32,
              nb_epoch: int | None = None,
              end_trigger: ZooTrigger | None = None,
              validation_set: FeatureSet | None = None,
              validation_trigger: ZooTrigger | None = None,
              seed: int | None = None, plan=None):
        """Train until ``end_trigger`` (default: ``nb_epoch`` more epochs,
        Keras continuation semantics) with every step under ``plan`` (a
        ``ShardingPlan`` or name; ``None`` defers to the estimator's plan,
        then ``dp``).  The optimizer state persists across calls, so a
        second fit continues the moments and the step count."""
        plan = self._resolve_plan(plan)
        step = compile_step(self.train_step, plan, label="train_step")
        if end_trigger is None:
            end_trigger = MaxEpoch(
                self.epoch - 1 + (nb_epoch if nb_epoch is not None else 10))
        if validation_set is not None and validation_trigger is None:
            validation_trigger = EveryEpoch()
        seed = self.ctx.seed if seed is None else seed
        params, state = self.model.build_params()
        device = self.model.device
        opt_state = (self._opt_state if self._opt_state is not None
                     else self.optimizer.init(params))
        tstate = TrainingState(epoch=self.epoch, iteration=self.global_step)
        epoch = self.epoch
        while not end_trigger(tstate):
            t0 = time.perf_counter()
            losses = []
            for batch in train_set.batches(batch_size, shuffle=True,
                                           seed=seed, epoch=epoch,
                                           drop_last=True):
                rng = step_generator(seed & 0x7FFFFFFF, self.global_step,
                                     device)
                params, opt_state, state, loss = step(
                    params, opt_state, state, rng,
                    _to_device(batch, device))
                self.global_step += 1
                losses.append(loss)
                tstate.iteration = self.global_step
                tstate.epoch_finished = False
                tstate.loss = loss
                self._maybe_validate(tstate, params, state, validation_set,
                                     validation_trigger, batch_size, plan)
            # the epoch boundary: the one host sync of the loop
            values = torch.stack(losses).tolist() if losses else []
            first = self.global_step - len(values) + 1
            self.loss_log.extend(
                (first + i, v) for i, v in enumerate(values))
            tstate.loss = values[-1] if values else None
            dt = time.perf_counter() - t0
            throughput = len(values) * batch_size / max(dt, 1e-9)
            logger.info("epoch %d done: loss=%s, %.1f records/s, step=%d",
                        epoch, tstate.loss, throughput, self.global_step)
            self.history.append({"epoch": epoch, "loss": tstate.loss,
                                 "throughput": throughput})
            epoch += 1
            tstate.epoch = epoch
            tstate.epoch_finished = True
            self._maybe_validate(tstate, params, state, validation_set,
                                 validation_trigger, batch_size, plan)
        self.epoch = epoch
        self.model.params = params
        self.model.state = state
        self._opt_state = opt_state
        return self

    def _maybe_validate(self, tstate, params, state, validation_set,
                        validation_trigger, batch_size, plan):
        if validation_set is None or validation_trigger is None \
                or not validation_trigger(tstate):
            return
        results = compile_step(self._evaluate_with, plan, label="eval_step")(
            params, state, validation_set, batch_size)
        tstate.score = next((v for k, v in results.items() if k != "loss"),
                            -results.get("loss", 0.0))
        logger.info("validation @ step %d: %s", tstate.iteration, results)

    def evaluate(self, val_set: FeatureSet, batch_size: int = 32) -> dict:
        """Loss and metrics over ``val_set``, unshuffled, every record
        counted once."""
        if getattr(self.model, "params", None) is None \
                and self.global_step == 0:
            logger.warning(
                "evaluate() called before any training: materializing "
                "fresh random weights; metrics reflect an untrained model")
        params, state = self.model.build_params()
        return compile_step(self._evaluate_with, self._resolve_plan(),
                            label="eval_step")(params, state, val_set,
                                               batch_size)

    def _evaluate_with(self, params, state, val_set, batch_size=32) -> dict:
        device = self.model.device
        dtype = self.ctx.compute_dtype
        accum = None
        with torch.no_grad():
            for batch in val_set.batches(batch_size, shuffle=False,
                                         drop_last=False, pad_to_batch=1):
                batch = _to_device(batch, device)
                preds, _ = self.model.forward(
                    cast_floats(params, dtype),
                    cast_floats(batch["x"], dtype), state=state,
                    training=False)
                preds = cast_floats(preds, torch.float32)
                rows = preds[0].shape[0] if isinstance(preds, list) \
                    else preds.shape[0]
                mask = (torch.arange(rows, device=device)
                        < batch["n_valid"]).float()
                stats = []
                if self.loss is not None and "y" in batch:
                    per = self.loss(batch["y"], preds)
                    stats.append(((per * mask).sum(), mask.sum()))
                for m in self.metrics:
                    stats.append(m.batch_stats(batch["y"], preds, mask=mask))
                accum = stats if accum is None else [
                    [a + b for a, b in zip(ga, gb)]
                    for ga, gb in zip(accum, stats)]
        results = {}
        idx = 0
        if self.loss is not None:
            num, den = accum[idx]
            results["loss"] = float(num) / max(float(den), 1e-12)
            idx += 1
        for m in self.metrics:
            results[m.name] = m.finalize([float(s) for s in accum[idx]])
            idx += 1
        return results
