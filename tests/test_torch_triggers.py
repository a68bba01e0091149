"""The port's triggers against the reference's on the same
``TrainingState`` sequences.

A sequence is what a fit shows its triggers: one state per dispatch, the
iteration in strides of K (an epoch's tail in strides of 1), and at each
epoch boundary the same iteration again with ``epoch_finished`` set, with
losses and validation scores drawn from a seed.  Each trigger of the
port and the reference's trigger built from the same arguments must give
the same answer at every state (the stateful ``SeveralIteration``
included), exactly.
"""

import numpy as np
import pytest

from analytics_zoo_tpu.common import triggers as jt
from analytics_zoo_tpu_torch.common import triggers as tt

STEPS_PER_EPOCH = 7
EPOCHS = 3


def _states(mod, k: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    it = 0
    for epoch in range(1, EPOCHS + 1):
        done = 0
        while done < STEPS_PER_EPOCH:
            n = k if STEPS_PER_EPOCH - done >= k else 1
            done += n
            it += n
            out.append(mod.TrainingState(
                epoch=epoch, iteration=it, epoch_finished=False,
                loss=float(rng.uniform(0, 2)),
                score=float(rng.uniform(0, 1)) if rng.random() < 0.5
                else None))
        out.append(mod.TrainingState(
            epoch=epoch + 1, iteration=it, epoch_finished=True,
            loss=float(rng.uniform(0, 2)), score=float(rng.uniform(0, 1))))
    return out


def _build(mod, spec):
    name, *args = spec
    if name in ("And", "Or"):
        return getattr(mod, name)(*[_build(mod, a) for a in args])
    if name == "&":
        return _build(mod, args[0]) & _build(mod, args[1])
    if name == "|":
        return _build(mod, args[0]) | _build(mod, args[1])
    return getattr(mod, name)(*args)


SPECS = [
    ("EveryEpoch",),
    ("SeveralIteration", 1), ("SeveralIteration", 3), ("SeveralIteration", 4),
    ("MaxEpoch", 2), ("MaxIteration", 10), ("MinLoss", 0.5),
    ("MaxScore", 0.7),
    ("And", ("EveryEpoch",), ("MaxIteration", 8)),
    ("Or", ("MinLoss", 0.2), ("SeveralIteration", 5), ("MaxScore", 0.9)),
    ("&", ("SeveralIteration", 2), ("MinLoss", 1.0)),
    ("|", ("EveryEpoch",), ("SeveralIteration", 3)),
]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_trigger_matches_the_reference(spec, k):
    ref, port = _build(jt, spec), _build(tt, spec)
    want = [ref(s) for s in _states(jt, k, 11)]
    got = [port(s) for s in _states(tt, k, 11)]
    assert got == want
    assert any(want) or spec[0] in ("MaxScore",)


def test_several_iteration_rejects_a_bad_interval():
    for mod in (jt, tt):
        with pytest.raises(ValueError, match="positive"):
            mod.SeveralIteration(0)
