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

A captured train step updates in place, as the reference's step donates
its buffers: :meth:`Optimizer.update_` writes the new state over the old
and returns the updates, and :func:`apply_updates_` adds them to the
parameters where they are, with the arithmetic of the functional
``update`` and :func:`apply_updates`, so with their bits.  Adam's moments
go :meth:`~Optimizer.in_layout` once first, where its kernel writes them.

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
    fused_update_,
    in_layout,
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

    def update_(self, grads, opt_state, params=None):
        """:meth:`update` in place: ``opt_state``'s leaves become the new
        state; returns the updates."""
        raise NotImplementedError

    def in_layout(self, opt_state):
        """``opt_state`` as :meth:`update_` takes it."""
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

    def _operands(self, grads, opt_state):
        """(scalars, count_inc, [g], [mu], [nu], kernel): the step's device
        scalars and incremented count, the leaves matched by key, and
        whether the plan leaves ``optimizer.adam`` to the kernel."""
        hp = self.hyperparams
        lr = hp["learning_rate"]
        lr_fn = lr if callable(lr) else (lambda _count: lr)
        scalars, count_inc = adam_scalars(opt_state.count, lr_fn, hp["b1"],
                                          hp["b2"], hp["eps"])
        triples = []  # (g, mu, nu) per leaf, matched by key
        tree_map_many(lambda *t: triples.append(t), grads, opt_state.mu,
                      opt_state.nu)
        g, mu, nu = (list(ts) for ts in zip(*triples))
        return (scalars, count_inc, g, mu, nu,
                resolve_kernel("optimizer.adam") != "xla")

    def update(self, grads, opt_state, params=None):
        """(updates, new_state): the updates are added to the parameters
        by the caller, as ``optax.apply_updates`` does."""
        scalars, count_inc, g, mu, nu, kernel = self._operands(grads,
                                                               opt_state)
        upd, mu, nu = fused_update(g, mu, nu, scalars, kernel=kernel)
        return (_unflatten(grads, upd),
                AdamState(count_inc, _unflatten(grads, mu),
                          _unflatten(grads, nu)))

    def update_(self, grads, opt_state, params=None):
        """:meth:`update` in place: the moments take mu' and nu' where
        they are (the kernel's leaves, laid out by :meth:`in_layout`, from
        the kernel itself) and the count its increment; returns the
        updates."""
        scalars, count_inc, g, mu, nu, kernel = self._operands(grads,
                                                               opt_state)
        upd = fused_update_(g, mu, nu, scalars, kernel=kernel)
        opt_state.count.copy_(count_inc)
        return _unflatten(grads, upd)

    def in_layout(self, opt_state):
        """The moments that the kernel updates on the card as views of one
        flat buffer each (a copy, once), as :meth:`update_` takes them."""
        out = []
        for tree in (opt_state.mu, opt_state.nu):
            leaves = []
            tree_map_many(leaves.append, tree)
            out.append(_unflatten(tree, in_layout(leaves)))
        return AdamState(opt_state.count, *out)


def _unflatten(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` in visiting order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def apply_updates(params, updates):
    """``optax.apply_updates``: p + u in the parameter's dtype."""
    return tree_map_many(lambda p, u: (p + u).to(p.dtype), params, updates)


def apply_updates_(params, updates) -> None:
    """:func:`apply_updates` in place: p += u, one multi-tensor add over
    the leaves whose update has their dtype (each leaf else on its own)."""
    pairs = []
    tree_map_many(lambda p, u: pairs.append((p, u)), params, updates)
    same = [(p, u) for p, u in pairs if p.dtype == u.dtype]
    if same:
        torch._foreach_add_(*map(list, zip(*same)))
    for p, u in pairs:
        if p.dtype != u.dtype:
            p.copy_((p + u).to(p.dtype))


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
