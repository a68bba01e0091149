"""Estimator — the training loop (single-device subset).

Counterpart of ``analytics_zoo_tpu/pipeline/estimator/estimator.py``.  One
train step is the reference's ``one_step`` (estimator.py:936-1007) in eager
PyTorch: the forward with ``training=True`` and the step's generator, the
f32 loss mean, the backward (``torch.autograd.grad``), frozen-layer
masking, gradient clipping, the optimizer update and
``optax.apply_updates``.  The step's generator is
``step_generator(seed, global_step)`` on the model's device, the
counterpart of ``fold_in(PRNGKey(seed), step)``.

A conv net trains the same way: BatchNorm's moving statistics are the
model state, updated in place by each step (f32 under every compute
dtype), and ``SGD`` updates its momentum and count in place, with its
learning rate computed on the device from the count.

On the card the three training scopes take their kernels, as the JAX
package does under ``ZOO_USE_PALLAS=1``: attention (flash forward and
backward, where ``flash_eligible`` holds), ``loss.softmax_xent`` (2-D
logits with 1-D labels) and ``optimizer.adam`` (f32 leaves of at least 128
elements).  The train step runs under a plan
(``Estimator(plan=)``/``train(plan=)``, default ``dp``) through
``parallel.plan.compile_step``, as in the reference, so a plan's
``kernel_rules`` can opt a scope out with ``"xla"`` (its plain PyTorch
path).

Mixed precision, as in the reference (estimator.py:939-981): under a plan
with ``dtype_rules`` (``mixed_precision()``, ``"dp+bf16"``, or the
context's ``ZOO_DTYPE_POLICY`` overlaid on a plan without dtype rules) the
forward takes the per-role compute copy of the f32 masters
(``plan.compute_dtypes``, worked out once per fit) and the batch's
floating inputs in ``plan.compute_cast_dtype()``.  The casts are made
where autograd records them, so gradients arrive in f32; predictions go up
to f32 before the loss, the new state keeps the old state's dtypes, and
the masters and Adam's moments stay f32.  The eval step casts the same way
under the estimator's own plan (not a fit's ``plan=``), as the reference's
``_resolved_plan()`` gives it.  Every compute dtype a plan can name (bf16,
f16) has its kernel instances on the card, so an f16 plan
(``"dp+f16"``, ``ZOO_DTYPE_POLICY=".*=f16"``) trains there as bf16 does,
with no loss scaling (the reference has none).

``fit`` runs through the compile plane, as the reference's does
(estimator.py:1012-1051): each dispatch is :meth:`Estimator._dispatch`,
K train steps (``ZOO_STEPS_PER_DISPATCH``, the context's
``steps_per_dispatch``) that update the parameters, the optimizer state
and the model state in place (the reference donates them), through
``compile_step`` under the labels ``train_step{tag}`` and
``train_step_scan{k}{tag}`` (``tag`` is ``_<plan>`` for a plan other than
``dp``).  On the card the first dispatch of a signature runs eagerly (it
is step 1: it warms cuBLAS and loads the kernel libraries) and is
captured into a CUDA graph, which every later dispatch replays: one host
call a dispatch.  Inner step i takes global step step0 + i for its
randomness (``common.engine.StepRandomness``, the reference's in-graph
``fold_in``), so the masks are those of :meth:`train_step`, which stays
the uncaptured yardstick, and every K gives the K=1 trajectory bit for
bit.  An epoch's tail shorter than K runs the K=1 step.  Each dispatch's
losses go into a per-epoch device buffer, read once at the epoch
boundary; triggers fire once per dispatch, at its K-step boundary, as in
the reference.  ``fit`` works on its own copies of the parameters and
state (the model's tensors stay as they were until it hands the trained
ones over at the end); a later ``fit`` of the same estimator continues on
them in place.  :meth:`Estimator.warmup` captures the steps before the
first real batch.  The eval step (:meth:`Estimator.eval_step`, the
reference's per-batch ``eval_step``) goes through ``compile_step`` under
the ``eval_step`` label, captured on the card per batch shape, with the
parameters and state passed by reference (the buffers ``fit`` updates in
place); the loop over the set, the sums of the per-batch statistics and
``finalize`` stay outside it, as in the reference.  ``evaluate`` and
``fit``'s validation both run it.

Batches come from ``FeatureSet.batches`` with the reference's seeded
shuffle, so both packages see the same batches in the same order; on the
card they go up from pinned memory without waiting for the device.
``history`` holds one record per epoch, as in the reference;
``loss_log`` holds every step's ``(iteration, loss)``, the values the
reference writes as TensorBoard ``Loss`` scalars.  Not ported yet (ROADMAP
queue 1, item 6): sharded plans, checkpoints and resume, the prefetch and
autotune planes, TensorBoard and metrics.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import (
    StepRandomness,
    cast_floats,
    get_zoo_context,
)
from analytics_zoo_tpu_torch.common.triggers import (
    EveryEpoch,
    MaxEpoch,
    TrainingState,
    ZooTrigger,
)
from analytics_zoo_tpu_torch.common.utils import (
    tree_leaves,
    tree_map,
    tree_map_many,
)
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.parallel.plan import (
    CaptureGroup,
    cast_to_compute,
    compile_step,
    resolve_plan,
    with_dtype_policy,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    _unflatten,
    apply_updates,
    apply_updates_,
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


def _cast_params(params, casts):
    """``params`` as the forward takes them under ``casts`` (see
    ``Estimator.compute_casts``)."""
    param_dtypes, dtype = casts
    if param_dtypes is None:
        return cast_floats(params, dtype)
    return cast_to_compute(params, param_dtypes)


def _tensor(a, device):
    """A batch array as a tensor on ``device``; float64 becomes float32, as
    JAX's default (x64 off) makes it.  To a CUDA device it goes from
    pinned memory, without waiting for the device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _chunks(batches, k: int):
    """Lists of K batches, then the tail one batch a list (the reference's
    ``_chunk_batches``: the same batch sequence as K=1)."""
    chunk = []
    for b in batches:
        chunk.append(b)
        if len(chunk) == k:
            yield chunk
            chunk = []
    for b in chunk:
        yield [b]


def _to_device(batch, device):
    """A host batch's arrays as tensors on ``device``; ``n_valid`` (the
    real rows of a padded batch) as a 0-d int32 tensor there, so that a
    captured eval step reads it from device memory."""
    out = {}
    for k, v in batch.items():
        if k == "n_valid":
            out[k] = _tensor(np.asarray(v, np.int32), device)
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
        # the plan the last fit ran under: its name and dtype policy
        # ("" = none), as the reference's checkpoint plan record holds them
        self._plan_record: dict | None = None
        # the compile plane: train and eval steps per (K or None, plan),
        # the randomness of each K-step dispatch per (K, device), and the
        # buffers the last dispatch updated in place
        self._steps: dict = {}
        self._randomness: dict = {}
        self._buffers = None

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def compute_casts(self, plan, params):
        """What a step under ``plan`` casts to: (each leaf's compute dtype
        as a tree of ``params``' structure, or None to cast every floating
        leaf to the batch's dtype; the batch's floating dtype, None for
        f32).  A plan's dtype rules beat the context's ``compute_dtype``.
        It depends on the tree's structure alone, so it is worked out once
        per fit or evaluate."""
        dtype = self.ctx.compute_dtype
        if plan is None or not plan.dtype_rules:
            return None, dtype
        return (plan.compute_dtypes(params),
                plan.compute_cast_dtype() or dtype)

    def loss_and_grads(self, params, state, batch, rng, casts=None):
        """(loss, grads, new_state) of one training forward and backward;
        ``batch`` holds tensors on the model's device, ``rng`` is the step's
        generator, ``casts`` (from :meth:`compute_casts`; None: the
        context's ``compute_dtype``) the compute casts.  Gradients have the
        masters' dtypes; integer leaves get zero gradients."""
        casts = casts or (None, self.ctx.compute_dtype)
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in tree_leaves(params)]
        p = _unflatten(params, leaves)
        with torch.enable_grad():
            # cast inside the recorded region: the casts' backward brings
            # the gradients up to f32 at the masters
            preds, new_state = self.model.forward(
                _cast_params(p, casts), cast_floats(batch["x"], casts[1]),
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
        if casts != (None, None):
            # the state keeps its dtypes from step to step
            new_state = tree_map_many(lambda new, old: new.to(old.dtype),
                                      new_state, state)
        return loss.detach(), _unflatten(params, grads), new_state

    def _mask_frozen(self, tree):
        frozen = getattr(self.model, "_frozen", ()) or ()
        if not frozen:
            return tree
        return {k: tree_map(torch.zeros_like, v) if k in frozen else v
                for k, v in tree.items()}

    def train_step(self, params, opt_state, state, rng, batch, casts=None):
        """One optimizer step under ``casts`` (:meth:`compute_casts`):
        (params, opt_state, state, loss)."""
        loss, grads, state = self.loss_and_grads(params, state, batch, rng,
                                                 casts)
        # frozen layers: grads AND updates masked to zero (the reference's
        # transfer-learning contract)
        grads = _clip_grads(self._mask_frozen(grads), self.grad_clip)
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(grads, opt_state,
                                                       params)
            params = apply_updates(params, self._mask_frozen(updates))
        return params, opt_state, state, loss

    def _step_(self, params, opt_state, state, rng, batch, casts):
        """:meth:`train_step` in place, as the reference's donated step:
        ``params``, ``opt_state`` and ``state`` take their new values where
        they are, with the same arithmetic; returns the loss."""
        loss, grads, new_state = self.loss_and_grads(params, state, batch,
                                                     rng, casts)
        grads = _clip_grads(self._mask_frozen(grads), self.grad_clip)
        with torch.no_grad():
            updates = self.optimizer.update_(grads, opt_state, params)
            apply_updates_(params, self._mask_frozen(updates))
            tree_map_many(lambda old, new: old.copy_(new), state, new_state)
        return loss

    def _dispatch(self, params, opt_state, state, keys, batches, casts):
        """``len(batches)`` train steps in place, inner step i under
        ``keys[i]`` (global step ``keys.step0 + i``): (params, opt_state,
        state, the (K,) f32 losses)."""
        losses = [self._step_(params, opt_state, state, keys[i], batch,
                              casts) for i, batch in enumerate(batches)]
        return params, opt_state, state, torch.stack(losses)

    def _train_step_for(self, k: int, plan):
        """The planned K-step dispatch under ``plan``, made once."""
        key = (k, plan.cache_key())
        step = self._steps.get(key)
        if step is None:
            tag = "" if plan.name == "dp" else f"_{plan.name}"
            label = f"train_step{tag}" if k == 1 \
                else f"train_step_scan{k}{tag}"
            step = self._steps[key] = compile_step(
                self._dispatch, plan, label=label, donate_argnums=(0, 1, 2))
        return step

    def _eval_step_for(self, plan):
        """The planned per-batch eval step under ``plan``, made once: the
        parameters and state by reference, its captures in one pool."""
        key = (None, plan.cache_key())
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = compile_step(
                self.eval_step, plan, label="eval_step", ref_argnums=(0, 1),
                group=CaptureGroup())
        return step

    def _keys(self, k: int, device, seed: int, step0: int):
        """The root keys of a K-step dispatch from global step ``step0``."""
        key = (k, str(device))
        src = self._randomness.get(key)
        if src is None:
            src = self._randomness[key] = StepRandomness(device, k)
        return src.keys(seed & 0x7FFFFFFF, step0)

    def _steps_per_dispatch(self, value=None) -> int:
        k = self.ctx.steps_per_dispatch if value is None else int(value)
        if k < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        return k

    def _own(self, params, opt_state, state):
        """The buffers a fit updates in place: those of this estimator's
        last dispatch when ``params`` are them, else copies (the moments
        laid out where the fused Adam kernel writes them)."""
        if self._buffers is not None and self._buffers[0] is params:
            return self._buffers
        # the eval captures read the buffers they were made on: drop them
        self._steps = {k: v for k, v in self._steps.items()
                       if k[0] is not None}
        return (tree_map(torch.clone, params),
                self.optimizer.in_layout(tree_map(torch.clone, opt_state)),
                tree_map(torch.clone, state))

    # ------------------------------------------------------------------
    # train / evaluate
    # ------------------------------------------------------------------
    def _resolve_plan(self, plan=None):
        """The effective plan: ``plan`` over the estimator's, then ``dp``,
        with the context's dtype policy (``ZOO_DTYPE_POLICY``) overlaid on
        a plan that has no dtype rules (explicit beats environment)."""
        plan = resolve_plan(plan if plan is not None else self.plan)
        policy = self.ctx.dtype_policy
        if not policy or plan.dtype_rules:
            return plan
        if policy.strip().lower() == "auto":
            raise NotImplementedError(
                'dtype policy "auto" (ZOO_DTYPE_POLICY) is resolved by the '
                "config oracle, which is not ported yet (ROADMAP queue 1 "
                'item 19); set a concrete policy such as "bf16_mixed"')
        return with_dtype_policy(plan, policy)

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
        # validation runs under the estimator's own plan, as in the
        # reference; resolved only when there is a validation set
        eval_plan = (self._resolve_plan() if validation_set is not None
                     else None)
        k = self._steps_per_dispatch()
        if end_trigger is None:
            end_trigger = MaxEpoch(
                self.epoch - 1 + (nb_epoch if nb_epoch is not None else 10))
        if validation_set is not None and validation_trigger is None:
            validation_trigger = EveryEpoch()
        seed = self.ctx.seed if seed is None else seed
        params, state = self.model.build_params()
        device = self.model.device
        casts = self.compute_casts(plan, params)
        eval_casts = None
        if eval_plan is not None:
            eval_casts = self.compute_casts(eval_plan, params)
        self._plan_record = {"name": plan.name,
                             "dtype_policy": plan.dtype_policy_str()}
        opt_state = (self._opt_state if self._opt_state is not None
                     else self.optimizer.init(params))
        params, opt_state, state = self._own(params, opt_state, state)
        tstate = TrainingState(epoch=self.epoch, iteration=self.global_step)
        epoch = self.epoch
        while not end_trigger(tstate):
            t0 = time.perf_counter()
            # every step's loss, read once at the epoch boundary
            losses = torch.empty(train_set.num_samples // batch_size,
                                 dtype=torch.float32, device=device)
            done = 0
            for chunk in _chunks(train_set.batches(
                    batch_size, shuffle=True, seed=seed, epoch=epoch,
                    drop_last=True), k):
                n = len(chunk)
                params, opt_state, state, out = self._train_step_for(
                    n, plan)(params, opt_state, state,
                             self._keys(n, device, seed, self.global_step),
                             [_to_device(b, device) for b in chunk], casts)
                self._buffers = (params, opt_state, state)
                losses[done:done + n].copy_(out)
                done += n
                self.global_step += n
                tstate.iteration = self.global_step
                tstate.epoch_finished = False
                tstate.loss = losses[done - 1]
                self._maybe_validate(tstate, params, state, validation_set,
                                     validation_trigger, batch_size,
                                     eval_plan, eval_casts)
            # the epoch boundary: the one host sync of the loop
            values = losses[:done].tolist()
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
                                 validation_trigger, batch_size, eval_plan,
                                 eval_casts)
        self.epoch = epoch
        self.model.params = params
        self.model.state = state
        self._opt_state = opt_state
        return self

    def _maybe_validate(self, tstate, params, state, validation_set,
                        validation_trigger, batch_size, plan, casts):
        if validation_set is None or validation_trigger is None \
                or not validation_trigger(tstate):
            return
        results = self._evaluate_with(params, state, validation_set,
                                      batch_size, casts, plan)
        tstate.score = next((v for k, v in results.items() if k != "loss"),
                            -results.get("loss", 0.0))
        logger.info("validation @ step %d: %s", tstate.iteration, results)

    def evaluate(self, val_set: FeatureSet, batch_size: int = 32) -> dict:
        """Loss and metrics over ``val_set``, unshuffled, every record
        counted once, under the estimator's plan (a fit's ``plan=`` does
        not carry over, as in the reference)."""
        if getattr(self.model, "params", None) is None \
                and self.global_step == 0:
            logger.warning(
                "evaluate() called before any training: materializing "
                "fresh random weights; metrics reflect an untrained model")
        params, state = self.model.build_params()
        plan = self._resolve_plan()
        return self._evaluate_with(params, state, val_set, batch_size,
                                   self.compute_casts(plan, params), plan)

    def warmup(self, batch: dict, steps_per_dispatch: int | None = None,
               plan=None) -> dict:
        """Capture the train steps before the first real batch (the
        reference's ``warmup``, estimator.py:1863-1940): the K=1 step and,
        when ``steps_per_dispatch`` (default: the context's
        ``ZOO_STEPS_PER_DISPATCH``) is K > 1, the K-step one, each by one
        dispatch on ``batch`` (an example host batch ``{"x": ..., "y":
        ...}`` of the batch size fit will use) against fresh buffers: the
        model's parameters and the optimizer state are left untouched.  A
        later ``fit`` under the same plan replays these captures.  Returns
        ``{label: seconds}``, each dispatch's time to ready (on the card
        its eager run and its capture; on the CPU the eager step)."""
        plan = self._resolve_plan(plan)
        k = self._steps_per_dispatch(steps_per_dispatch)
        params, state = self.model.build_params()
        device = self.model.device
        casts = self.compute_casts(plan, params)
        params, opt_state, state = (
            tree_map(torch.clone, params),
            self.optimizer.in_layout(self.optimizer.init(params)),
            tree_map(torch.clone, state))
        out = {}
        for kk in sorted({1, k}):
            step = self._train_step_for(kk, plan)
            t0 = time.perf_counter()
            res = step(params, opt_state, state,
                       self._keys(kk, device, self.ctx.seed, 0),
                       [_to_device(batch, device) for _ in range(kk)], casts)
            res[-1].tolist()  # ready: the dispatch has run
            out[step.label] = time.perf_counter() - t0
            params, opt_state, state = res[:3]
        logger.info("warmup captured %s", out)
        return out

    def eval_step(self, params, state, batch, casts=None) -> list:
        """One batch's statistics (the reference's ``eval_step``,
        estimator.py:1053-1098): the forward with the compute casts of
        ``casts`` (:meth:`compute_casts`; None: the context's
        ``compute_dtype``), predictions up to f32, the rows past
        ``batch["n_valid"]`` (a device scalar) masked out, then the loss's
        (sum, count) and each metric's ``batch_stats``, all on the
        device.  The state stays as stored (f32 running statistics)."""
        casts = casts or (None, self.ctx.compute_dtype)
        with torch.no_grad():
            preds, _ = self.model.forward(
                _cast_params(params, casts),
                cast_floats(batch["x"], casts[1]), state=state,
                training=False)
            preds = cast_floats(preds, torch.float32)
            first = preds[0] if isinstance(preds, list) else preds
            mask = (torch.arange(first.shape[0], device=first.device)
                    < batch["n_valid"]).float()
            stats = []
            if self.loss is not None and "y" in batch:
                per = self.loss(batch["y"], preds)
                stats.append(((per * mask).sum(), mask.sum()))
            for m in self.metrics:
                stats.append(m.batch_stats(batch["y"], preds, mask=mask))
        return stats

    def _evaluate_with(self, params, state, val_set, batch_size=32,
                       casts=None, plan=None, step=None) -> dict:
        """Loss and metrics over ``val_set``: each batch through the
        planned eval step (``step``, default :meth:`eval_step` under
        ``plan`` through ``compile_step``, captured on the card), its
        statistics summed on the device in batch order, ``finalize`` on
        the host at the end."""
        device = self.model.device
        step = step or self._eval_step_for(self._resolve_plan(plan))
        accum = None
        for batch in val_set.batches(batch_size, shuffle=False,
                                     drop_last=False, pad_to_batch=1):
            batch = _to_device(batch, device)
            with step.lock:  # the next replay overwrites the statistics
                stats = step(params, state, batch, casts)
                accum = [[s.clone() for s in g] for g in stats] \
                    if accum is None else [
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
