"""Trigger algebra for validation / checkpoint / end-of-training scheduling.

Re-design of the reference's ``ZooTrigger`` family
(zoo/.../common/ZooTrigger.scala:25-80): triggers are pure predicates over a
``TrainingState`` record, so they compose (``And``/``Or``).  The
reference's triggers close over a BigDL optimizer state table; ours take
an explicit state — no hidden mutation, which keeps the training loop a
plain host-side loop around one step.

The port's own copy of ``analytics_zoo_tpu/common/triggers.py`` (which
imports no JAX), with the same classes and rules: the epoch triggers,
``SeveralIteration``'s boundary-crossing rule under K-step dispatch,
``MaxIteration``, ``MinLoss``, ``MaxScore``, ``And`` and ``Or``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainingState:
    """Host-side training progress record checked by triggers."""

    epoch: int = 1           # 1-based current epoch
    iteration: int = 0       # global step count (optimizer updates)
    epoch_finished: bool = False  # True exactly when an epoch boundary was hit
    loss: float | None = None
    score: float | None = None    # last validation score (higher is better)
    records_in_epoch: int = 0


class ZooTrigger:
    """Base trigger: callable ``trigger(state) -> bool``.

    Reference: ZooTrigger.scala:25-35.
    """

    def __call__(self, state: TrainingState) -> bool:
        raise NotImplementedError

    def __and__(self, other: "ZooTrigger") -> "ZooTrigger":
        return And(self, other)

    def __or__(self, other: "ZooTrigger") -> "ZooTrigger":
        return Or(self, other)


class EveryEpoch(ZooTrigger):
    """Fires at each epoch boundary (ZooTrigger.scala:42-67)."""

    def __call__(self, state: TrainingState) -> bool:
        return state.epoch_finished


class SeveralIteration(ZooTrigger):
    """Fires every ``interval`` optimizer steps (ZooTrigger.scala:69-80).

    Boundary-crossing semantics: fires when a multiple of ``interval``
    lies in ``(previous observed iteration, current iteration]``.  One
    step at a time this is ``iteration % interval == 0``; under K-step
    dispatch, where the loop observes iterations in strides of K, it
    keeps the configured cadence (fires at the first boundary past each
    multiple) instead of collapsing to ``lcm(K, interval)``.  The first
    observation (a resume mid-run included: no catch-up firing) and a
    re-observed iteration (the epoch-boundary callback) take the
    exact-hit rule.
    """

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = int(interval)
        self._prev: int | None = None

    def __call__(self, state: TrainingState) -> bool:
        it, n = state.iteration, self.interval
        if it <= 0:
            return False
        prev, self._prev = self._prev, it
        if prev is None or it <= prev:
            return it % n == 0
        return (it // n) > (prev // n)


class MaxEpoch(ZooTrigger):
    """End-trigger: stop after ``max_epoch`` epochs complete."""

    def __init__(self, max_epoch: int):
        self.max_epoch = int(max_epoch)

    def __call__(self, state: TrainingState) -> bool:
        return state.epoch > self.max_epoch


class MaxIteration(ZooTrigger):
    """End-trigger: holds once ``max_iteration`` optimizer steps ran (a
    fit checks its end trigger at epoch boundaries, so it ends with the
    epoch in which this first holds)."""

    def __init__(self, max_iteration: int):
        self.max_iteration = int(max_iteration)

    def __call__(self, state: TrainingState) -> bool:
        return state.iteration >= self.max_iteration


class MinLoss(ZooTrigger):
    """Fires once the last loss falls below ``min_loss``."""

    def __init__(self, min_loss: float):
        self.min_loss = float(min_loss)

    def __call__(self, state: TrainingState) -> bool:
        return state.loss is not None and bool(state.loss < self.min_loss)


class MaxScore(ZooTrigger):
    """Fires once the last validation score exceeds ``max_score``."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def __call__(self, state: TrainingState) -> bool:
        return state.score is not None and state.score > self.max_score


class And(ZooTrigger):
    def __init__(self, first: ZooTrigger, *rest: ZooTrigger):
        self.triggers = (first,) + rest

    def __call__(self, state: TrainingState) -> bool:
        return all(t(state) for t in self.triggers)


class Or(ZooTrigger):
    def __init__(self, first: ZooTrigger, *rest: ZooTrigger):
        self.triggers = (first,) + rest

    def __call__(self, state: TrainingState) -> bool:
        return any(t(state) for t in self.triggers)
