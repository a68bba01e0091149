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

``SGD`` is optax's ``chain(add_decayed_weights(weight_decay),
sgd(lr, momentum, nesterov))``: the weight decay is added to the gradient
of every leaf (biases and BatchNorm's gamma and beta included) before the
momentum trace, and the step is ``-lr(count) · update``.  Its state,
:class:`SGDState`, holds the trace (none without momentum) and the
schedule's count.  SGD has no kernel: its update is a few multi-tensor
(``torch._foreach_*``) passes over the leaves, the same ops in ``update``
and ``update_``.

Schedules are functions of the step count (a 0-d int tensor) returning a
multiplier, written with torch ops so they run on the count's device: a
captured step computes its learning rate on the device from the count it
reads there, never from a Python float baked in at capture.

The other optimizers of the reference's table have optax's state and
arithmetic too, and no kernel (in the reference the kernel plane rebuilds
only ``Adam``): ``AdamWeightDecay`` (optax ``adamw``: Adam's moments and
bias correction, then ``weight_decay * p`` added for every leaf, biases
and norms included, then the scheduled rate; the BERT recipe's
``warmup_linear_decay`` from ``warmup_portion`` and ``total``),
``RMSprop`` (eps inside the square root), ``Adagrad`` (an accumulator
that starts at 0.1, ``rsqrt(acc + eps)`` where it is positive),
``Adadelta`` and ``Adamax`` (only the first moment bias-corrected; the
infinity norm ``max(|g| + eps, b2 u)``).  Each keeps its step count on the
device and evaluates its schedule there at the count before the
increment, as ``SGD`` does, and runs its update as multi-tensor
(``torch._foreach_*``) passes over the leaves, the same ops in ``update``
and ``update_`` (``rsqrt`` and ``where``, which have none, leaf by leaf).
``get_optimizer`` resolves every name of the reference's table; the
schedules are ``warmup_linear_decay``, ``warmup_epoch_decay`` and
``poly_decay``.
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
    _int_pow,
    adam_scalars,
    fused_update,
    fused_update_,
    in_layout,
    safe_increment,
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


def warmup_epoch_decay(warmup_steps: int, steps_per_epoch: int,
                       boundaries_epochs=(30, 60, 80), decay: float = 0.1,
                       warmup_start: float = 0.0) -> Schedule:
    """ResNet-ImageNet multiplier: linear warmup from ``warmup_start`` to
    1 over ``warmup_steps``, then ``decay`` at each epoch boundary (the
    reference's ``warmup_epoch_decay``)."""

    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        frac = torch.clamp(step / float(max(warmup_steps, 1)), max=1.0)
        warm = warmup_start + (1.0 - warmup_start) * frac
        epoch = step / steps_per_epoch
        mult = torch.ones((), dtype=torch.float32, device=step.device)
        for b in boundaries_epochs:
            mult = mult * torch.where(epoch >= b, decay, 1.0)
        return torch.where(step < warmup_steps, warm, mult)

    return fn


def poly_decay(power: float, max_steps: int) -> Schedule:
    """``max(0, 1 - step / max_steps) ** power`` (the reference's
    ``poly_decay``)."""

    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        return torch.clamp(1.0 - step / max_steps, min=0.0) ** power

    return fn


def _scheduled(lr, schedule):
    if schedule is None:
        return lr
    return lambda step: lr * schedule(step)


def _step_size(lr, count):
    """``-lr(count)``: a device scalar for a schedule (optax's
    ``scale_by_schedule``), a float for a constant rate (``scale``)."""
    if callable(lr):
        return -(lr(count).to(torch.float32))
    return -float(lr)


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


class SGDState(NamedTuple):
    """optax ``sgd``'s state after ``add_decayed_weights``: the schedule's
    step count (0-d int32; optax keeps it only for a scheduled rate, the
    port always) and the momentum trace, a tree shaped like the
    parameters, or ``()`` without momentum."""

    count: torch.Tensor
    trace: object


class SGD(Optimizer):
    """The reference's ``SGD``: momentum (optax's ``trace``), Nesterov,
    ``decay`` (the 1/(1 + decay*step) schedule) and ``weight_decay``
    (``add_decayed_weights``, before the trace)."""

    def __init__(self, lr=0.01, momentum=0.0, decay=0.0, nesterov=False,
                 weight_decay=0.0, schedule: Optional[Schedule] = None):
        sched = schedule
        if decay and sched is None:
            sched = lambda step: 1.0 / (1.0 + decay * step.to(torch.float32))  # noqa: E731
        super().__init__("sgd", lr, sched)
        self.momentum = float(momentum or 0.0)
        self.nesterov = bool(nesterov)
        self.weight_decay = float(weight_decay or 0.0)
        self._lr = _scheduled(lr, sched)

    def init(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        trace = tree_map(torch.zeros_like, params) if self.momentum else ()
        return SGDState(torch.zeros((), dtype=torch.int32, device=device),
                        trace)

    def _run(self, grads, opt_state, params, in_place: bool):
        """(updates, new trace leaves, count_inc), all the leaves matched
        by key; ``in_place`` writes the gradients' and the trace's new
        values over them (the same ops, so the same bits)."""
        if self.weight_decay and params is None:
            raise ValueError("SGD with weight_decay needs the parameters")
        leaves = []  # (g, p, t) per leaf, matched by key
        trace = opt_state.trace if self.momentum else tree_map(
            lambda _: None, grads)
        tree_map_many(lambda *t: leaves.append(t), grads,
                      params if params is not None else grads, trace)
        g, p, t = (list(x) for x in zip(*leaves))
        if self.weight_decay:
            decayed = torch._foreach_mul(p, self.weight_decay)
            if in_place:
                torch._foreach_add_(g, decayed)
            else:
                g = torch._foreach_add(g, decayed)
        if self.momentum:
            if in_place:
                torch._foreach_mul_(t, self.momentum)
                torch._foreach_add_(t, g)
            else:
                t = torch._foreach_add(g, torch._foreach_mul(
                    t, self.momentum))
            u = t
            if self.nesterov:
                u = torch._foreach_add(g, torch._foreach_mul(
                    t, self.momentum))
        else:
            u = g
        upd = torch._foreach_mul(u, _step_size(self._lr, opt_state.count))
        return upd, t, safe_increment(opt_state.count)

    def update(self, grads, opt_state, params=None):
        upd, t, count_inc = self._run(grads, opt_state, params, False)
        trace = _unflatten(grads, t) if self.momentum else ()
        return _unflatten(grads, upd), SGDState(count_inc, trace)

    def update_(self, grads, opt_state, params=None):
        """:meth:`update` in place: the trace and the count take their new
        values where they are (the gradients are overwritten too);
        returns the updates."""
        upd, _, count_inc = self._run(grads, opt_state, params, True)
        opt_state.count.copy_(count_inc)
        return _unflatten(grads, upd)

    def in_layout(self, opt_state):
        return opt_state


def _ema(t, x, decay, in_place):
    """optax's ``update_moment``: ``(1 - decay) * x + decay * t`` per leaf;
    ``in_place`` writes it over ``t``."""
    a = torch._foreach_mul(x, 1.0 - decay)
    if in_place:
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, a)
        return t
    return torch._foreach_add(a, torch._foreach_mul(t, decay))


class _MultiTensor(Optimizer):
    """An optimizer whose state is its schedule's step count and trees
    shaped like the parameters (``STATE``'s fields after ``count``, made
    by ``init`` filled with ``FILLS``), updated by multi-tensor passes:
    :meth:`_direction` turns the gradients into the update's direction and
    the new moments, and the scheduled rate scales it (optax's
    ``scale_by_learning_rate``)."""

    STATE: type = None
    FILLS: tuple = ()
    NEEDS_PARAMS = False

    def __init__(self, name, lr, schedule):
        super().__init__(name, lr, schedule)
        self._lr = _scheduled(lr, schedule)

    def init(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        return self.STATE(
            torch.zeros((), dtype=torch.int32, device=device),
            *(tree_map(lambda t, v=v: torch.full_like(t, v), params)
              for v in self.FILLS))

    def _direction(self, g, p, moments, count_inc, in_place):
        """(direction, new moments), lists of leaves; ``in_place`` writes
        the new moments over ``moments`` (the same ops)."""
        raise NotImplementedError

    def _run(self, grads, opt_state, params, in_place):
        if self.NEEDS_PARAMS and params is None:
            raise ValueError(f"{type(self).__name__} needs the parameters")
        rows = []  # (g, p, *moments) per leaf, matched by key
        tree_map_many(lambda *t: rows.append(t), grads,
                      params if params is not None else grads,
                      *opt_state[1:])
        g, p, *moments = (list(c) for c in zip(*rows))
        count_inc = safe_increment(opt_state.count)
        u, new = self._direction(g, p, moments, count_inc, in_place)
        upd = torch._foreach_mul(u, _step_size(self._lr, opt_state.count))
        return upd, new, count_inc

    def update(self, grads, opt_state, params=None):
        upd, new, count_inc = self._run(grads, opt_state, params, False)
        return _unflatten(grads, upd), self.STATE(
            count_inc, *(_unflatten(grads, m) for m in new))

    def update_(self, grads, opt_state, params=None):
        """:meth:`update` in place: the moments and the count take their
        new values where they are; returns the updates."""
        upd, _, count_inc = self._run(grads, opt_state, params, True)
        opt_state.count.copy_(count_inc)
        return _unflatten(grads, upd)

    def in_layout(self, opt_state):
        return opt_state


def _bias_corrections(decays, count):
    """optax's bias corrections ``1 - decay ** count`` (f32, the power
    rounded as the reference rounds it), one 0-d device tensor each."""
    return (1.0 - _int_pow(tuple(decays), count)).unbind(0)


class AdamWeightDecay(_MultiTensor):
    """The reference's BERT optimizer, optax ``adamw``: Adam's update
    ``mu_hat / (sqrt(nu_hat) + eps)``, plus ``weight_decay * p`` on every
    leaf, times the scheduled rate.  With ``total`` > 0 and no
    ``schedule``, the rate follows ``warmup_linear_decay(int(
    warmup_portion * total), total)``.  No kernel: the state is optax's
    ``ScaleByAdamState``, :class:`AdamState`."""

    STATE = AdamState
    FILLS = (0.0, 0.0)

    def __init__(self, lr=0.001, warmup_portion=-1.0, total=-1,
                 schedule=None, beta_1=0.9, beta_2=0.999, epsilon=1e-6,
                 weight_decay=0.01):
        sched = schedule
        if sched is None and total > 0:
            warmup = int(max(warmup_portion, 0.0) * total)
            sched = warmup_linear_decay(warmup, total)
        super().__init__("adamw", lr, sched)
        self.b1, self.b2, self.eps = beta_1, beta_2, epsilon
        self.weight_decay = weight_decay

    NEEDS_PARAMS = True

    def _direction(self, g, p, moments, count_inc, in_place):
        mu = _ema(moments[0], g, self.b1, in_place)
        nu = _ema(moments[1], torch._foreach_mul(g, g), self.b2, in_place)
        bc1, bc2 = _bias_corrections((self.b1, self.b2), count_inc)
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, bc2)), self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        return torch._foreach_add(
            u, torch._foreach_mul(p, self.weight_decay)), [mu, nu]


class RMSpropState(NamedTuple):
    """optax ``scale_by_rms``'s second moment and the schedule's count."""

    count: torch.Tensor
    nu: object


class RMSprop(_MultiTensor):
    """optax ``rmsprop(lr, decay=rho, eps)``: ``g * rsqrt(nu + eps)``, eps
    inside the square root."""

    STATE = RMSpropState
    FILLS = (0.0,)

    def __init__(self, lr=0.001, rho=0.9, epsilon=1e-8,
                 schedule: Optional[Schedule] = None):
        super().__init__("rmsprop", lr, schedule)
        self.rho, self.eps = rho, epsilon

    def _direction(self, g, p, moments, count_inc, in_place):
        nu = _ema(moments[0], torch._foreach_mul(g, g), self.rho, in_place)
        scale = [torch.rsqrt(n) for n in torch._foreach_add(nu, self.eps)]
        return torch._foreach_mul(scale, g), [nu]


class AdagradState(NamedTuple):
    """optax ``scale_by_rss``'s sum of squares (from 0.1) and the
    schedule's count."""

    count: torch.Tensor
    sum_of_squares: object


class Adagrad(_MultiTensor):
    """optax ``adagrad(lr, eps)``: the sum of squared gradients from 0.1,
    and ``g * rsqrt(sum + eps)`` where the sum is positive (0 elsewhere)."""

    STATE = AdagradState
    FILLS = (0.1,)

    def __init__(self, lr=0.01, epsilon=1e-8,
                 schedule: Optional[Schedule] = None):
        super().__init__("adagrad", lr, schedule)
        self.eps = epsilon

    def _direction(self, g, p, moments, count_inc, in_place):
        sq = torch._foreach_mul(g, g)
        if in_place:
            torch._foreach_add_(moments[0], sq)
            acc = moments[0]
        else:
            acc = torch._foreach_add(sq, moments[0])
        scale = [torch.where(a > 0, torch.rsqrt(a + self.eps), 0.0)
                 for a in acc]
        return torch._foreach_mul(scale, g), [acc]


class AdadeltaState(NamedTuple):
    """optax ``scale_by_adadelta``'s averages of squared gradients and of
    squared updates, and the schedule's count."""

    count: torch.Tensor
    e_g: object
    e_x: object


class Adadelta(_MultiTensor):
    """optax ``adadelta(lr, rho, eps)``: ``g * sqrt(e_x + eps) /
    sqrt(e_g + eps)`` with e_g updated first and e_x after, from the new
    direction (optax's zero weight decay adds ``0 * p``, which changes no
    finite value, and is left out)."""

    STATE = AdadeltaState
    FILLS = (0.0, 0.0)

    def __init__(self, lr=1.0, rho=0.95, epsilon=1e-8,
                 schedule: Optional[Schedule] = None):
        super().__init__("adadelta", lr, schedule)
        self.rho, self.eps = rho, epsilon

    def _direction(self, g, p, moments, count_inc, in_place):
        e_g = _ema(moments[0], torch._foreach_mul(g, g), self.rho, in_place)
        num = torch._foreach_sqrt(torch._foreach_add(moments[1], self.eps))
        den = torch._foreach_sqrt(torch._foreach_add(e_g, self.eps))
        u = torch._foreach_mul(torch._foreach_div(num, den), g)
        e_x = _ema(moments[1], torch._foreach_mul(u, u), self.rho, in_place)
        return u, [e_g, e_x]


class Adamax(_MultiTensor):
    """optax ``adamax(lr, b1, b2, eps)``: the first moment bias-corrected,
    over the infinity norm ``u = max(|g| + eps, b2 u)``.  Its state is
    optax's ``ScaleByAdamState`` (nu is u), :class:`AdamState`."""

    STATE = AdamState
    FILLS = (0.0, 0.0)

    def __init__(self, lr=0.002, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 schedule: Optional[Schedule] = None):
        super().__init__("adamax", lr, schedule)
        self.b1, self.b2, self.eps = beta_1, beta_2, epsilon

    def _direction(self, g, p, moments, count_inc, in_place):
        mu = _ema(moments[0], g, self.b1, in_place)
        norm = torch._foreach_add(torch._foreach_abs(g), self.eps)
        if in_place:
            torch._foreach_mul_(moments[1], self.b2)
            torch._foreach_maximum_(moments[1], norm)
            nu = moments[1]
        else:
            nu = torch._foreach_maximum(
                norm, torch._foreach_mul(moments[1], self.b2))
        (bc1,) = _bias_corrections((self.b1,), count_inc)
        return torch._foreach_div(torch._foreach_div(mu, bc1), nu), [mu, nu]


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


_OPTIMIZERS = {
    "sgd": SGD,
    "adam": Adam,
    "adamw": AdamWeightDecay,
    "rmsprop": RMSprop,
    "adagrad": Adagrad,
    "adadelta": Adadelta,
    "adamax": Adamax,
}


def get_optimizer(identifier) -> Optimizer:
    if isinstance(identifier, Optimizer):
        return identifier
    if isinstance(identifier, str) and identifier.lower() in _OPTIMIZERS:
        return _OPTIMIZERS[identifier.lower()]()
    raise ValueError(f"unknown optimizer {identifier!r}")
