"""The port's autograd facade against the JAX package's.

Every ``AutoGrad`` op and every ``Variable`` operator is built into a
symbolic ``Model`` in both packages from the same code and run on the same
seeded inputs; the forward values agree within 1e-6 of the output's
largest magnitude, the gradients with respect to the inputs (of the sum of
the output times a seeded cotangent) within 1e-5 of the gradient's largest
magnitude (the packages reduce in different orders).  The inputs plant
exact ties for ``clip`` and ``maximum`` (both packages split the gradient
evenly there), broadcast a (1, 4) operand against (3, 4) and use negative
axes.  The same ops run eagerly on tensors, as inside a ``CustomLoss``
body, to the same tolerances.  ``index_select`` out of range gives NaN
(the smallest int32 for integers) and wraps a negative index once, as
``jnp.take`` does; ``Lambda`` infers the reference's shapes; a trainable
and a frozen ``Parameter`` keep the reference's trees (``value`` in the
parameters or in the state), carry over by ``params_from_jax`` and train
alike; the two ``examples/autograd`` models take one Adam step to the same
loss (1e-5 relative) and parameters (1e-4 of each leaf's largest); a
``CustomLoss`` that returns a ``Variable`` raises ``TypeError`` in both.
One fit batch is 8 records: the JAX package's CPU mesh has 8 devices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu_torch.convert import params_from_jax

SEED, B = 3, 4
FWD_TOL, GRAD_TOL = 1e-6, 1e-5
LOSS_RTOL, STEP_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _contexts():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init

    saved = (jax_engine._CONTEXT, torch_engine._CONTEXT,
             torch.get_num_threads())
    torch.set_num_threads(1)
    jax_init(seed=SEED)
    torch_init(seed=SEED, device="cpu")
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved[:2]
    torch.set_num_threads(saved[2])


def _pkg(name):
    """(autograd module, Input, Model) of ``name`` ("jax" or "torch")."""
    if name == "jax":
        from analytics_zoo_tpu.pipeline.api import autograd as A
        from analytics_zoo_tpu.pipeline.api.keras import Input, Model
    else:
        from analytics_zoo_tpu_torch.pipeline.api import autograd as A
        from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    return A, Input, Model


def _inputs():
    rng = np.random.default_rng(SEED)
    a = rng.normal(size=(B, 3, 4)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, size=(B, 3, 4)).astype(np.float32)
    a.flat[0], a.flat[1], a.flat[2] = 0.5, -0.5, 0.1  # clip / maximum ties
    a.flat[3] = b.flat[3]                             # maximum(a, b) tie
    return {
        "a": a, "b": b,
        "c": rng.normal(size=(B, 1, 4)).astype(np.float32),
        "p": rng.normal(size=(B, 4, 5)).astype(np.float32),
        "q": rng.normal(size=(B, 5, 4)).astype(np.float32),
        "u": rng.normal(size=(B, 6)).astype(np.float32),
        "w": rng.normal(size=(B, 6)).astype(np.float32),
        "s": rng.normal(size=(B, 1, 4)).astype(np.float32),
    }


# (name, inputs, a function of (autograd module, *inputs) making the op)
SYMBOLIC = [
    ("add", "ab", lambda A, a, b: a + b),
    ("add_broadcast", "ac", lambda A, a, c: a + c),
    ("radd", "a", lambda A, a: 2.0 + a),
    ("sub", "ab", lambda A, a, b: a - b),
    ("sub_broadcast", "ca", lambda A, c, a: c - a),
    ("rsub", "a", lambda A, a: 1.0 - a),
    ("mul", "ab", lambda A, a, b: a * b),
    ("mul_const", "a", lambda A, a: a * 3.0),
    ("rmul", "a", lambda A, a: 3.0 * a),
    ("div", "ab", lambda A, a, b: a / b),
    ("div_const", "a", lambda A, a: a / 4.0),
    ("rdiv", "b", lambda A, b: 2.0 / b),
    ("pow_const", "b", lambda A, b: b ** 2.0),
    ("pow_variable", "ba", lambda A, b, a: b ** a),
    ("neg", "a", lambda A, a: -a),
    ("slice", "a", lambda A, a: a.slice(1, 1, 2)),
    ("slice_last", "a", lambda A, a: a.slice(2, 0, 3)),
    ("index_select", "a", lambda A, a: a.index_select(1, 2)),
    ("index_select_negative_dim", "a", lambda A, a: a.index_select(-1, 1)),
    ("index_select_negative_index", "a", lambda A, a: a.index_select(2, -1)),
    ("index_select_out_of_range", "a", lambda A, a: a.index_select(2, 4)),
    ("index_select_below_range", "a", lambda A, a: a.index_select(1, -4)),
    ("squeeze", "s", lambda A, s: s.squeeze(1)),
    ("squeeze_negative", "s", lambda A, s: s.squeeze(-2)),
    ("abs", "a", lambda A, a: A.abs(a)),
    ("sum_default_axis", "a", lambda A, a: A.sum(a)),
    ("sum", "a", lambda A, a: A.sum(a, axis=1)),
    ("sum_keepdims_negative", "a",
     lambda A, a: A.sum(a, axis=-1, keepdims=True)),
    ("mean_default_axis", "a", lambda A, a: A.mean(a)),
    ("mean", "a", lambda A, a: A.mean(a, axis=2)),
    ("mean_keepdims", "a", lambda A, a: A.mean(a, axis=1, keepdims=True)),
    ("clip", "a", lambda A, a: A.clip(a, -0.5, 0.5)),
    ("square", "a", lambda A, a: A.square(a)),
    ("sqrt", "b", lambda A, b: A.sqrt(b)),
    ("exp", "a", lambda A, a: A.exp(a)),
    ("log", "b", lambda A, b: A.log(b)),
    ("pow", "b", lambda A, b: A.AutoGrad.pow(b, 1.5)),
    # of two Variables the reference's shape rule passes the list of input
    # shapes through, so the node has two outputs and the first holds the
    # value; eagerly ``[0]`` is the first record
    ("maximum", "ab", lambda A, a, b: A.maximum(a, b)[0]),
    ("maximum_const", "a", lambda A, a: A.maximum(a, 0.1)),
    ("erf", "a", lambda A, a: A.erf(a)),
    ("softsign", "a", lambda A, a: A.AutoGrad.softsign(a)),
    ("softplus", "a", lambda A, a: A.AutoGrad.softplus(a)),
    ("l2_normalize", "a", lambda A, a: A.l2_normalize(a)),
    ("l2_normalize_axis1", "a", lambda A, a: A.l2_normalize(a, axis=1)),
    ("mm", "ap", lambda A, a, p: A.mm(a, p)),
    ("mm_axes", "aq", lambda A, a, q: A.mm(a, q, axes=[2, 2])),
    ("mm_axes_negative", "aq", lambda A, a, q: A.mm(a, q, axes=[-1, -1])),
    ("mm_2d_axes", "uw", lambda A, u, w: A.mm(u, w, axes=[1, 1])),
    ("batch_dot", "aq", lambda A, a, q: A.batch_dot(a, q)),
    ("batch_dot_normalize", "aq",
     lambda A, a, q: A.batch_dot(a, q, normalize=True)),
    ("batch_dot_axes_1", "ab", lambda A, a, b: A.batch_dot(a, b, axes=(1, 1))),
    ("contiguous", "a", lambda A, a: A.AutoGrad.contiguous(a) * 1.0),
    ("expand_dims", "a", lambda A, a: A.expand_dims(a, 1)),
    ("expand_dims_negative", "a", lambda A, a: A.expand_dims(a, -1)),
    ("stack", "ab", lambda A, a, b: A.stack([a, b], axis=1)),
    ("stack_negative", "ab", lambda A, a, b: A.stack([a, b], axis=-1)),
    ("composite", "ab", lambda A, a, b: A.mean(
        A.square(A.clip(a - b, -1.0, 1.0)) + A.log(b) / 2.0, axis=1)),
]
EAGER = [c for c in SYMBOLIC if c[0].split("_")[0] in (
    "abs", "sum", "mean", "clip", "square", "sqrt", "exp", "log", "pow",
    "maximum", "erf", "softsign", "softplus", "l2", "mm", "batch",
    "contiguous", "expand", "stack", "composite")]


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if not ok.any():
        return 0.0
    return np.abs(got - want)[ok].max() / max(np.abs(want[ok]).max(), 1e-30)


def _jax_value_and_grads(fn, arrays, cot):
    out = fn(*arrays)
    grads = jax.grad(lambda *xs: jnp.nansum(fn(*xs) * cot),
                     argnums=tuple(range(len(arrays))))(*arrays)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_value_and_grads(fn, arrays):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts)
    return out, ts


def _check(jout, jgrads, tout, ts, cot):
    assert _err(tout.detach().numpy(), jout) <= FWD_TOL
    if tout.requires_grad:  # a fill (index out of range) has no inputs
        torch.nansum(tout * torch.from_numpy(cot)).backward()
    for t, g in zip(ts, jgrads):
        got = torch.zeros_like(t) if t.grad is None else t.grad
        assert _err(got.numpy(), g) <= GRAD_TOL


@pytest.mark.parametrize("name, ins, build", SYMBOLIC,
                         ids=[c[0] for c in SYMBOLIC])
def test_op_matches_jax_on_a_graph(name, ins, build):
    """The op as a node of a symbolic ``Model``: the Variable's inferred
    shape, the forward and the input gradients."""
    arrays = [_inputs()[k] for k in ins]
    models = {}
    for pkg in ("jax", "torch"):
        A, Input, Model = _pkg(pkg)
        vs = [Input(shape=a.shape[1:]) for a in arrays]
        out = build(A, *vs)
        models[pkg] = (Model(vs if len(vs) > 1 else vs[0], out), out.shape)
    (jm, jshape), (tm, tshape) = models["jax"], models["torch"]
    assert tshape == jshape
    jm.build_params()
    tm.build_params()

    def jfn(*xs):
        return jm.forward({}, list(xs) if len(xs) > 1 else xs[0])[0]

    def tfn(*xs):
        return tm.forward({}, list(xs) if len(xs) > 1 else xs[0])[0]

    jout = np.asarray(jfn(*arrays))
    cot = np.random.default_rng(1).normal(size=jout.shape) \
        .astype(np.float32)
    jout, jgrads = _jax_value_and_grads(jfn, arrays, cot)
    tout, ts = _torch_value_and_grads(tfn, arrays)
    _check(jout, jgrads, tout, ts, cot)


@pytest.mark.parametrize("name, ins, build", EAGER,
                         ids=[c[0] for c in EAGER])
def test_op_matches_jax_eagerly(name, ins, build):
    """The ``AutoGrad`` op called on tensors, as inside a ``CustomLoss``
    body: the forward and the input gradients."""
    arrays = [_inputs()[k] for k in ins]
    JA, _, _ = _pkg("jax")
    TA, _, _ = _pkg("torch")
    jout = np.asarray(build(JA, *[jnp.asarray(a) for a in arrays]))
    cot = np.random.default_rng(2).normal(size=jout.shape) \
        .astype(np.float32)
    jout, jgrads = _jax_value_and_grads(lambda *xs: build(JA, *xs),
                                        [jnp.asarray(a) for a in arrays],
                                        cot)
    tout, ts = _torch_value_and_grads(lambda *xs: build(TA, *xs), arrays)
    _check(jout, jgrads, tout, ts, cot)


def test_take_matches_jnp_take_on_integers_and_bounds():
    """``take`` (``index_select``'s body) on int32 and float inputs at every
    index from -n - 1 to n: ``jnp.take``'s values, fills included."""
    from analytics_zoo_tpu_torch.pipeline.api.autograd import take

    xi = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    xf = xi.astype(np.float32)
    for x in (xi, xf):
        for dim in (0, 1, 2, -1, -2):
            n = x.shape[dim]
            for i in range(-n - 1, n + 1):
                want = np.asarray(jnp.take(x, i, axis=dim))
                got = take(torch.from_numpy(x), i, dim).numpy()
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_squeeze_of_a_wide_axis_raises_in_both():
    A, Input, _ = _pkg("torch")
    JA, JInput, _ = _pkg("jax")
    for In in (Input, JInput):
        v = In(shape=(2, 4))
        v2 = v.squeeze(1)  # the symbolic shape only drops the axis
        assert v2.shape == (None, 4)
    from analytics_zoo_tpu_torch.pipeline.api.autograd import _squeeze

    with pytest.raises(ValueError):
        jnp.squeeze(jnp.zeros((2, 2, 4)), axis=1)
    with pytest.raises(ValueError):
        _squeeze(torch.zeros(2, 2, 4), 1)


@pytest.mark.parametrize("fn, shapes, want", [
    (lambda t: t[:, :2] * 2.0, [(5,)], (None, 2)),
    (lambda t: t.reshape(t.shape[0], 3, 2), [(6,)], (None, 3, 2)),
    (lambda a, b: a * b + 1.0, [(3, 4), (3, 4)], (None, 3, 4)),
    ("sum", [(3, 4)], (None, 1, 4)),
    ("mm", [(3, 4), (4, 5)], (None, 3, 5)),
], ids=["slice", "reshape", "two_inputs", "autograd_sum", "autograd_mm"])
def test_lambda_infers_the_reference_shape_and_runs_alike(fn, shapes, want):
    """``Lambda``'s shape inference (meta-device dummies of batch 1 in the
    port, ``jax.eval_shape`` in the reference) and its forward."""
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(B,) + s).astype(np.float32) for s in shapes]
    outs, got_shapes = {}, {}
    for pkg in ("jax", "torch"):
        A, Input, Model = _pkg(pkg)
        f = {"sum": lambda t: A.sum(t, axis=1, keepdims=True),
             "mm": lambda a, b: A.mm(a, b)}.get(fn, fn)
        vs = [Input(shape=s) for s in shapes]
        out = A.Lambda(f)(vs if len(vs) > 1 else vs[0])
        got_shapes[pkg] = out.shape
        m = Model(vs if len(vs) > 1 else vs[0], out)
        outs[pkg] = m.predict(arrays if len(arrays) > 1 else arrays[0],
                              batch_size=8)
    assert got_shapes["torch"] == got_shapes["jax"] == want
    assert _err(outs["torch"], outs["jax"]) <= FWD_TOL


def _graph_with_parameter(pkg, trainable, init_weight=None):
    A, Input, Model = _pkg(pkg)
    if pkg == "jax":
        from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
    else:
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    x = Input(shape=(5,))
    w = A.Parameter((3,), init_weight=init_weight, trainable=trainable,
                    name="offset")()
    return Model(x, Dense(3)(x) * 2.0 + w)


def _carry(jm, tm):
    tm.build_params()
    jm.build_params()
    tm.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), device="cpu"))
    tm.state = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.state), device="cpu")


def _shapes(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(np.shape(a)), str(np.asarray(a).dtype)), tree)


def _one_adam_step(jm, tm, x, y, loss_pair, tmp_path, lr=1e-2):
    """One Adam step of both through ``fit`` on one batch of 8: the logged
    losses and every parameter after it (leaves whose update is at
    rounding level, moved by less than lr / 2, left out: Adam's first step
    moves each leaf by about lr times its gradient's sign)."""
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    before = jax.tree_util.tree_map(np.asarray, jm.params)
    jm.compile(optimizer=JAdam(lr), loss=loss_pair[0])
    tm.compile(optimizer=Adam(lr), loss=loss_pair[1])
    jm.set_tensorboard(str(tmp_path), "zoo")
    jm.fit(x, y, batch_size=8, nb_epoch=1)
    tm.fit(x, y, batch_size=8, nb_epoch=1)
    (jloss,) = {v for _, v, _ in jm._estimator._writers[0].read_scalar(
        "Loss")}
    ((_, tloss),) = tm._estimator.loss_log
    assert tloss == pytest.approx(jloss, rel=LOSS_RTOL)
    for layer, leaves in jm.params.items():
        for key, want in leaves.items():
            want = np.asarray(want)
            moved = np.abs(want - before[layer][key]) > 0.5 * lr
            got = tm.params[layer][key].numpy()
            assert np.abs(got - want)[moved].max(initial=0.0) <= \
                STEP_TOL * np.abs(want).max(), (layer, key)
    return jloss


@pytest.mark.parametrize("trainable", [True, False])
def test_parameter_matches_jax(tmp_path, trainable):
    """A graph adding a ``Parameter`` to a Dense output: the value in the
    parameters (trainable) or the state (frozen), the reference's tree
    carried over by ``params_from_jax``, the forward, one Adam step; the
    frozen value unchanged by it."""
    jm = _graph_with_parameter("jax", trainable)
    tm = _graph_with_parameter("torch", trainable)
    _carry(jm, tm)
    assert _shapes(tm.get_weights()) == _shapes(jm.params)
    assert _shapes(jax.tree_util.tree_map(lambda t: t.numpy(), tm.state)) \
        == _shapes(jm.state)
    where = tm.params if trainable else tm.state
    assert set(where["offset"]) == {"value"}
    assert ("offset" in tm.params) == trainable
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)
    want = np.asarray(jm.predict(x, batch_size=8))
    assert _err(tm.predict(x, batch_size=8), want) <= FWD_TOL
    frozen = None if trainable else tm.state["offset"]["value"].clone()
    _one_adam_step(jm, tm, x, y, ("mse", "mse"), tmp_path)
    if not trainable:
        assert torch.equal(tm.state["offset"]["value"], frozen)
        np.testing.assert_array_equal(
            tm.state["offset"]["value"].numpy(),
            np.asarray(jm.state["offset"]["value"]))


def test_parameter_init_weight_and_shape_check():
    init = np.arange(3, dtype=np.float32)
    for pkg in ("jax", "torch"):
        m = _graph_with_parameter(pkg, True, init_weight=init)
        m.build_params()
        np.testing.assert_array_equal(np.asarray(m.params["offset"]["value"]),
                                      init)
        A, _, _ = _pkg(pkg)
        with pytest.raises(ValueError, match="init_weight shape"):
            A.Parameter((4,), init_weight=init)()


def _custom_example(pkg):
    """examples/autograd/custom.py's model and loss: Dense(1) then a
    Lambda adding one, mean absolute error as a CustomLoss."""
    A, Input, Model = _pkg(pkg)
    if pkg == "jax":
        from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
    else:
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    inp = Input(shape=(4,))
    out = A.Lambda(lambda v: v + 1.0)(Dense(1)(inp))

    def mae(y_true, y_pred):
        return A.mean(A.abs(y_true - y_pred), axis=1)

    return Model(inp, out), A.CustomLoss(mae, [1])


def _customloss_example(pkg):
    """examples/autograd/customloss.py's model and loss: a Lambda scaling
    the input to 2x - 1, Dense(1), mean absolute error written in the
    package's array library."""
    A, _, _ = _pkg(pkg)
    if pkg == "jax":
        from analytics_zoo_tpu.pipeline.api.keras import Sequential
        from analytics_zoo_tpu.pipeline.api.keras.layers import Dense

        def mae(y_true, y_pred):
            return jnp.mean(jnp.abs(y_true - y_pred), axis=1)
    else:
        from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

        def mae(y_true, y_pred):
            return torch.mean(torch.abs(y_true - y_pred), dim=1)
    m = Sequential()
    m.add(A.Lambda(lambda t: t * 2.0 - 1.0, input_shape=(2,)))
    m.add(Dense(1))
    return m, A.CustomLoss(mae)


@pytest.mark.parametrize("example", ["custom", "customloss"])
def test_autograd_examples_take_the_same_adam_step(tmp_path, example):
    make = {"custom": _custom_example,
            "customloss": _customloss_example}[example]
    (jm, jloss), (tm, tloss) = make("jax"), make("torch")
    _carry(jm, tm)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (8, 4 if example == "custom" else 2)) \
        .astype(np.float32)
    y = ((2 * x).sum(1) + 0.4).reshape(8, 1).astype(np.float32)
    assert _err(tm.predict(x, batch_size=8),
                np.asarray(jm.predict(x, batch_size=8))) <= FWD_TOL
    _one_adam_step(jm, tm, x, y, (jloss, tloss), tmp_path, lr=0.05)
    # CustomLoss.forward evaluates eagerly on arrays
    yp = rng.normal(size=(8, 1))
    assert tloss.forward(y, yp) == pytest.approx(jloss.forward(y, yp),
                                                 rel=1e-6)


def test_custom_loss_reductions_match_jax():
    """A scalar result becomes one sample, a (B, 3) result its per-sample
    mean, in both packages."""
    JA, _, _ = _pkg("jax")
    TA, _, _ = _pkg("torch")
    rng = np.random.default_rng(8)
    yt = rng.normal(size=(6, 3)).astype(np.float32)
    yp = rng.normal(size=(6, 3)).astype(np.float32)
    for jf, tf in ((lambda a, b: jnp.sum((a - b) ** 2),
                    lambda a, b: torch.sum((a - b) ** 2)),
                   (lambda a, b: (a - b) ** 2, lambda a, b: (a - b) ** 2)):
        want = np.asarray(JA.CustomLoss(jf)(jnp.asarray(yt),
                                            jnp.asarray(yp)))
        got = TA.CustomLoss(tf)(torch.from_numpy(yt), torch.from_numpy(yp))
        assert got.shape == want.shape
        assert _err(got.numpy(), want) <= FWD_TOL


def test_custom_loss_returning_a_variable_raises_type_error():
    for pkg in ("jax", "torch"):
        A, Input, _ = _pkg(pkg)
        v = Input(shape=(1,))
        loss = A.CustomLoss(lambda y_true, y_pred: v)
        arr = jnp.zeros((2, 1)) if pkg == "jax" else torch.zeros(2, 1)
        with pytest.raises(TypeError, match="Variable"):
            loss(arr, arr)
