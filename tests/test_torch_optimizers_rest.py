"""``AdamWeightDecay``, ``RMSprop``, ``Adagrad``, ``Adadelta`` and
``Adamax`` against the JAX package's (optax's arithmetic).

Each starts from the reference's state after two of its own steps, carried
over by ``opt_state_from_jax``, and runs five more steps with a schedule in
both packages on the same seeded gradients: the parameters and every
state leaf within ``RTOL`` of the leaf's largest magnitude (f32 on both
sides; XLA and PyTorch round ``sqrt``, ``rsqrt`` and the divisions each in
their own way: measured below 1e-7), the counts equal.  ``update_`` (in
place, as a captured step runs it) gives ``update``'s bits.  Every name of
the reference's table resolves.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.convert import opt_state_from_jax
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as to

RTOL = 1e-6
STEPS = 5


def _reference():
    from analytics_zoo_tpu.pipeline.api.keras import optimizers as jo

    return jo


def _params(seed=0):
    gen = np.random.default_rng(seed)
    return {"dense_0": {"kernel": gen.normal(size=(12, 8)).astype(np.float32),
                        "bias": gen.normal(size=(8,)).astype(np.float32)},
            "ln": {"gamma": gen.normal(size=(8,)).astype(np.float32)}}


def _grads(step):
    gen = np.random.default_rng(100 + step)
    return tree_map(lambda a: gen.normal(size=a.shape).astype(np.float32),
                    _params())


# (name, the optimizer built in either module, the port's state type)
OPTIMIZERS = [
    ("adamw", lambda m: m.AdamWeightDecay(lr=0.01, warmup_portion=0.3,
                                          total=8, weight_decay=0.05),
     to.AdamState),
    ("rmsprop", lambda m: m.RMSprop(0.01, schedule=m.poly_decay(1.0, 10)),
     to.RMSpropState),
    ("adagrad", lambda m: m.Adagrad(0.1, schedule=m.warmup_linear_decay(
        2, 10)), to.AdagradState),
    ("adadelta", lambda m: m.Adadelta(schedule=m.poly_decay(2.0, 12)),
     to.AdadeltaState),
    ("adamax", lambda m: m.Adamax(schedule=m.warmup_linear_decay(3, 9)),
     to.AdamState),
]


def _np_leaves(state):
    """The state's trees as {path: numpy} (the count left out)."""
    out = {}
    for field in state._fields[1:]:
        for k, g in getattr(state, field).items():
            for n, v in g.items():
                out[f"{field}/{k}/{n}"] = np.asarray(v)
    return out


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= RTOL * scale, k


@pytest.mark.parametrize("name,make,state_type", OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_matches_the_reference(name, make, state_type):
    import jax
    import jax.numpy as jnp
    import optax

    jopt, topt = make(_reference()), make(to)
    assert topt.name == jopt.name == name
    jp = jax.tree_util.tree_map(jnp.asarray, _params())
    js = jopt.init(jp)
    for i in range(2):  # the reference's own first steps
        u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, _grads(i)),
                            js, jp)
        jp = optax.apply_updates(jp, u)
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                            device="cpu")
    assert isinstance(ts, state_type) and int(ts.count) == 2
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)),
                  jax.tree_util.tree_map(np.asarray, jp))
    # the in-place twin, from copies of the same start
    tp_, ts_ = tree_map(torch.clone, tp), topt.in_layout(
        type(ts)(ts.count.clone(), *(tree_map(torch.clone, t)
                                     for t in ts[1:])))
    for i in range(2, 2 + STEPS):
        g = _grads(i)
        u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tg = tree_map(torch.from_numpy, g)
        tu, ts = topt.update(tg, ts, tp)
        tp = to.apply_updates(tp, tu)
        tu_ = topt.update_(tree_map(torch.from_numpy, _grads(i)), ts_, tp_)
        to.apply_updates_(tp_, tu_)
    assert int(ts.count) == int(ts_.count) == 2 + STEPS
    want = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    assert int(want.count) == 2 + STEPS
    _close(_np_leaves(ts), _np_leaves(want))
    _close({f"{k}/{n}": v.numpy() for k, g in tp.items()
            for n, v in g.items()},
           {f"{k}/{n}": np.asarray(v) for k, g in jp.items()
            for n, v in g.items()})
    # update_ gives update's bits
    got_, got = _np_leaves(ts_), _np_leaves(ts)
    assert got_.keys() == got.keys()
    for k in got:
        np.testing.assert_array_equal(got_[k], got[k])
    for k, g in tp.items():
        for n, v in g.items():
            assert torch.equal(v, tp_[k][n]), (k, n)


@pytest.mark.parametrize("name,state_type", [
    ("rmsprop", to.RMSpropState), ("adagrad", to.AdagradState),
    ("adadelta", to.AdadeltaState), ("adamax", to.AdamState),
    ("adamw", to.AdamState)])
def test_constant_rate_state_converts_and_matches(name, state_type):
    """Without a schedule optax keeps no count beside the moments (Adam's
    own count aside): the port's count starts at 0, and one step from the
    reference's initial state agrees."""
    import jax
    import jax.numpy as jnp
    import optax

    jopt = _reference().get_optimizer(name)
    topt = to.get_optimizer(name)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(1))
    js = jopt.init(jp)
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                            device="cpu")
    assert isinstance(ts, state_type) and int(ts.count) == 0
    _close(_np_leaves(ts), _np_leaves(topt.init(tree_map(
        torch.from_numpy, _params(1)))))
    u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, _grads(0)), js,
                        jp)
    jp = optax.apply_updates(jp, u)
    tp = tree_map(torch.from_numpy, _params(1))
    tu, ts = topt.update(tree_map(torch.from_numpy, _grads(0)), ts, tp)
    tp = to.apply_updates(tp, tu)
    _close({f"{k}/{n}": v.numpy() for k, g in tp.items()
            for n, v in g.items()},
           {f"{k}/{n}": np.asarray(v) for k, g in jp.items()
            for n, v in g.items()})


def test_every_reference_optimizer_name_resolves():
    jo = _reference()
    assert sorted(to._OPTIMIZERS) == sorted(jo._OPTIMIZERS)
    for name, cls in jo._OPTIMIZERS.items():
        opt = to.get_optimizer(name)
        assert type(opt).__name__ == cls.__name__
        assert opt.name == cls().name
    with pytest.raises(ValueError, match="unknown optimizer"):
        to.get_optimizer("no_such_optimizer")


def test_adamw_needs_the_parameters():
    opt = to.AdamWeightDecay(lr=0.01)
    p = tree_map(torch.from_numpy, _params())
    with pytest.raises(ValueError, match="needs the parameters"):
        opt.update(tree_map(torch.from_numpy, _grads(0)), opt.init(p))


def test_adamw_schedule_is_the_references():
    """``warmup_portion`` and ``total`` give the rate the reference's
    ``warmup_linear_decay(int(warmup_portion * total), total)`` gives, at
    every count; step 1 (count 0) takes rate 0."""
    jo = _reference()
    jopt = jo.AdamWeightDecay(lr=2e-5, warmup_portion=0.1, total=50)
    topt = to.AdamWeightDecay(lr=2e-5, warmup_portion=0.1, total=50)
    for c in range(0, 55):
        got = float(topt._lr(torch.tensor(c, dtype=torch.int32)))
        assert got == pytest.approx(jopt.current_lr(c), rel=1e-6, abs=0)
    assert float(topt._lr(torch.tensor(0, dtype=torch.int32))) == 0.0
