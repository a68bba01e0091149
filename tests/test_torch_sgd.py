"""The port's ``SGD`` and its schedules against the JAX package's (optax).

The same numpy parameters and five steps of seeded gradients go through
the JAX package's ``SGD`` (its optax chain) and the port's, in four
cases: plain, momentum, Nesterov, and weight decay with each schedule
(``warmup_epoch_decay`` across its warmup's end and an epoch boundary,
``poly_decay``, and ``decay``'s 1/(1 + decay*step)).  Every step's updates
and parameters agree within 1e-6 of each leaf's largest magnitude (the
same f32 operations in the same order; measured 0), and the in-place
``update_`` gives ``update``'s bits.  The schedules alone agree within
1e-6 relative over their steps.  ``opt_state_from_jax`` carries optax's
SGD state (trace and count) over, and the next step is optax's.  The rate
a captured ``update_`` computes on the card is held by a ``cuda`` test in
``tests/test_torch_conv_models.py`` (a file the card's machine can import
without JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu_torch.common.utils import tree_leaves
from analytics_zoo_tpu_torch.convert import opt_state_from_jax
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt

TOL = 1e-6
SHAPES = {"conv": {"kernel": (3, 3, 2, 4)}, "bn": {"gamma": (4,),
                                                   "beta": (4,)},
          "fc": {"kernel": (4, 3), "bias": (3,)}}


def _jopt():
    from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt

    return jopt


def _tree(rng, scale=1.0, shapes=SHAPES):
    return {k: _tree(rng, scale, v) if isinstance(v, dict)
            else (scale * rng.normal(size=v)).astype(np.float32)
            for k, v in shapes.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _pairs(t_tree, j_tree):
    """(port leaf, JAX leaf) pairs matched by key."""
    out = []

    def walk(t, j):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], j[k])
        else:
            out.append((t.detach().numpy(), np.asarray(j)))

    walk(t_tree, j_tree)
    return out


def _err(a, b):
    return np.abs(a.astype(np.float64) - b).max() / max(np.abs(b).max(),
                                                        1e-30)


def _cases():
    return {
        "plain": lambda m: m.SGD(lr=0.1),
        "momentum": lambda m: m.SGD(lr=0.1, momentum=0.9),
        "nesterov": lambda m: m.SGD(lr=0.05, momentum=0.9, nesterov=True),
        "wd_warmup_epoch_decay": lambda m: m.SGD(
            lr=0.1, momentum=0.9, weight_decay=1e-2,
            schedule=m.warmup_epoch_decay(3, 1, boundaries_epochs=(4,),
                                          decay=0.1, warmup_start=0.1)),
        "wd_poly_decay": lambda m: m.SGD(
            lr=0.1, momentum=0.5, weight_decay=1e-3,
            schedule=m.poly_decay(2.0, 6)),
        "wd_decay": lambda m: m.SGD(lr=0.1, decay=0.5, weight_decay=1e-2),
    }


CASES = ("plain", "momentum", "nesterov", "wd_warmup_epoch_decay",
         "wd_poly_decay", "wd_decay")


@pytest.mark.parametrize("case", CASES)
def test_sgd_matches_optax_for_five_steps(case):
    make = _cases()[case]
    jsgd, tsgd = make(_jopt()), make(topt)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp, tp, tp_ = _jnp(params), _torch(params), _torch(params)
    js, ts = jsgd.init(jp), tsgd.init(tp)
    ts_ = tsgd.in_layout(tsgd.init(tp_))
    for step in range(5):
        g = _tree(rng, 0.1)
        ju, js = jsgd.update(_jnp(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = tsgd.update(_torch(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
        for a, b in _pairs(tu, ju) + _pairs(tp, jp):
            assert _err(a, b) <= TOL, (case, step)
        # in place: the same bits
        tu_ = tsgd.update_(_torch(g), ts_, tp_)
        topt.apply_updates_(tp_, tu_)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(tp_), tree_leaves(tp)))
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(ts_), tree_leaves(ts)))
    assert int(ts.count) == int(ts_.count) == 5
    if tsgd.momentum:
        jtrace = next(s for s in jax.tree_util.tree_leaves(
            js, is_leaf=lambda s: hasattr(s, "trace"))
            if hasattr(s, "trace")).trace
        for a, b in _pairs(ts.trace, jtrace):
            assert _err(a, b) <= TOL
    else:
        assert ts.trace == ()


@pytest.mark.parametrize("name,args", [
    ("warmup_epoch_decay", (5, 2, (3, 6, 8), 0.1, 0.0)),
    ("warmup_epoch_decay", (4, 3, (2,), 0.5, 0.25)),
    ("poly_decay", (0.9, 12)),
    ("poly_decay", (2.0, 7)),
    ("warmup_linear_decay", (3, 10)),
])
def test_schedules_match_jax(name, args):
    jfn, tfn = getattr(_jopt(), name)(*args), getattr(topt, name)(*args)
    for step in range(20):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = float(tfn(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=TOL, abs=1e-12), (step,)


def test_opt_state_from_jax_continues_an_sgd_trajectory():
    jsgd = _jopt().SGD(lr=0.1, momentum=0.9, weight_decay=1e-3,
                       schedule=_jopt().poly_decay(1.0, 10))
    tsgd = topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-3,
                    schedule=topt.poly_decay(1.0, 10))
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jp = _jnp(params)
    js = jsgd.init(jp)
    for _ in range(3):
        u, js = jsgd.update(_jnp(_tree(rng, 0.1)), js, jp)
        jp = optax.apply_updates(jp, u)
    state = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    assert isinstance(state, topt.SGDState) and int(state.count) == 3
    g = _tree(rng, 0.1)
    tu, state = tsgd.update(_torch(g), state, _torch(
        jax.tree_util.tree_map(np.asarray, jp)))
    ju, js = jsgd.update(_jnp(g), js, jp)
    for a, b in _pairs(tu, ju):
        assert _err(a, b) <= TOL
    assert int(state.count) == 4


def test_opt_state_from_jax_sgd_without_momentum():
    # a scheduled rate keeps a count and no trace
    jsgd = _jopt().SGD(lr=0.1, decay=0.1)
    js = jsgd.init(_jnp(_tree(np.random.default_rng(2))))
    state = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    assert int(state.count) == 0 and state.trace == ()
    # a constant rate without momentum has no arrays at all
    with pytest.raises(ValueError):
        opt_state_from_jax(_jopt().SGD(lr=0.1).init(
            _jnp(_tree(np.random.default_rng(2)))), device="cpu")


def test_get_optimizer_sgd():
    assert isinstance(topt.get_optimizer("sgd"), topt.SGD)
    assert isinstance(topt.get_optimizer("SGD"), topt.SGD)
    with pytest.raises(ValueError, match="weight_decay"):
        topt.SGD(weight_decay=1e-4).update(_torch(_tree(
            np.random.default_rng(0))), topt.SGD().init(_torch(_tree(
                np.random.default_rng(0)))))
