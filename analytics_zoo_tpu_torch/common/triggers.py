"""Trigger algebra for validation / checkpoint / end-of-training scheduling.

Re-design of the reference's ``ZooTrigger`` family
(zoo/.../common/ZooTrigger.scala:25-80): triggers are pure predicates over a
``TrainingState`` record.  The reference's triggers close over a BigDL
optimizer state table; ours take an explicit state — no hidden mutation,
which keeps the training loop a plain host-side loop around one step.

The port's own copy of the parts of ``analytics_zoo_tpu/common/triggers.py``
(which imports no JAX) that the estimator's epoch and validation
scheduling reads; the iteration, loss and score triggers and their
``And``/``Or`` algebra wait for their slice (ROADMAP queue 1, item 6).
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


class EveryEpoch(ZooTrigger):
    """Fires at each epoch boundary (ZooTrigger.scala:42-67)."""

    def __call__(self, state: TrainingState) -> bool:
        return state.epoch_finished


class MaxEpoch(ZooTrigger):
    """End-trigger: stop after ``max_epoch`` epochs complete."""

    def __init__(self, max_epoch: int):
        self.max_epoch = int(max_epoch)

    def __call__(self, state: TrainingState) -> bool:
        return state.epoch > self.max_epoch
