"""Optimizers — Keras-1 names with optax's semantics (training subset).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/optimizers.py``.  The
reference builds each optimizer from an optax transform; the port keeps
optax's state and arithmetic, so trajectories and checkpoints carry over:
``Adam`` has optax ``adam``'s state (``count``, ``mu``, ``nu``: the
``ScaleByAdamState`` leaves), evaluates a learning-rate schedule at the
pre-increment count and bias-corrects at the incremented one.  Its update
is the reference's ``fused_adam`` under the kernel plane: on the card the
update of every f32 leaf of at least 128 elements runs the CUDA kernel of
``ops/cuda/fused_adam.py``, unless the active plan's ``kernel_rules`` pick
``"xla"`` for ``optimizer.adam``; then every leaf takes the plain formula.  The oracle is ``optax.adam``, not
``torch.optim.Adam``, which groups its arithmetic differently.

Schedules are functions of the step count (a 0-d int tensor) returning a
multiplier, written with torch ops so they run on the count's device.
Ported so far: ``Adam`` and the ``warmup_linear_decay`` schedule; the
other optimizers and schedules wait for their slice (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from analytics_zoo_tpu_torch.common.utils import (
    tree_leaves,
    tree_map,
    tree_map_many,
)
from analytics_zoo_tpu_torch.ops.cuda.fused_adam import (
    adam_scalars,
    fused_update,
)
from analytics_zoo_tpu_torch.parallel.plan import resolve_kernel

Schedule = Callable[[torch.Tensor], torch.Tensor]


def warmup_linear_decay(warmup_steps: int, total_steps: int) -> Schedule:
    """BERT-style warmup-then-linear-decay multiplier (the reference's
    ``warmup_linear_decay``)."""

    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = float(max(warmup_steps, 1))
        lin = float(max(total_steps - warmup_steps, 1))
        return torch.where(
            step < warmup_steps, step / warm,
            torch.clamp(1.0 - (step - warmup_steps) / lin, min=0.0))

    return fn


def _scheduled(lr, schedule):
    if schedule is None:
        return lr
    return lambda step: lr * schedule(step)


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: the step count (0-d int32) and the first
    and second moments, trees shaped like the parameters."""

    count: torch.Tensor
    mu: object
    nu: object


class Optimizer:
    """An update rule with optax's ``init``/``update`` protocol over the
    port's parameter trees."""

    def __init__(self, name: str, learning_rate: float = 0.01,
                 schedule: Optional[Schedule] = None):
        self.name = name
        self.learning_rate = learning_rate
        self.schedule = schedule

    def init(self, params):
        raise NotImplementedError

    def update(self, grads, opt_state, params=None):
        raise NotImplementedError


class Adam(Optimizer):
    """The reference's ``Adam`` (schedule-aware; ``decay`` is the
    1/(1 + decay*step) schedule)."""

    def __init__(self, lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 decay=0.0, schedule: Optional[Schedule] = None):
        sched = schedule
        if decay and sched is None:
            sched = lambda step: 1.0 / (1.0 + decay * step.to(torch.float32))  # noqa: E731
        super().__init__("adam", lr, sched)
        self.hyperparams = {"learning_rate": _scheduled(lr, sched),
                            "b1": beta_1, "b2": beta_2, "eps": epsilon}

    def init(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    def update(self, grads, opt_state, params=None):
        """(updates, new_state): the updates are added to the parameters
        by the caller, as ``optax.apply_updates`` does."""
        hp = self.hyperparams
        lr = hp["learning_rate"]
        lr_fn = lr if callable(lr) else (lambda _count: lr)
        scalars, count_inc = adam_scalars(opt_state.count, lr_fn, hp["b1"],
                                          hp["b2"], hp["eps"])
        triples = []  # (g, mu, nu) per leaf, matched by key
        tree_map_many(lambda *t: triples.append(t), grads, opt_state.mu,
                      opt_state.nu)
        kernel = resolve_kernel("optimizer.adam") != "xla"
        upd, mu, nu = fused_update(*zip(*triples), scalars, kernel=kernel)
        return (_unflatten(grads, upd),
                AdamState(count_inc, _unflatten(grads, mu),
                          _unflatten(grads, nu)))


def _unflatten(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` in visiting order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def apply_updates(params, updates):
    """``optax.apply_updates``: p + u in the parameter's dtype."""
    return tree_map_many(lambda p, u: (p + u).to(p.dtype), params, updates)


_OPTIMIZERS = {"adam": Adam}


def get_optimizer(identifier) -> Optimizer:
    if isinstance(identifier, Optimizer):
        return identifier
    if isinstance(identifier, str) and identifier.lower() in _OPTIMIZERS:
        return _OPTIMIZERS[identifier.lower()]()
    if isinstance(identifier, str):
        raise NotImplementedError(
            f"optimizer {identifier!r} is not ported yet (ROADMAP queue 1, "
            f"item 4); ported: {sorted(_OPTIMIZERS)}")
    raise ValueError(f"unknown optimizer {identifier!r}")
