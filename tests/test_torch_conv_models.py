"""The port's conv-net models against the JAX package's: ResNet and
LeNet-5 built, trained and served in both, from the same weights on the
same numpy data.  The ResNet-50 cases draw the weights in the port and
copy them into the reference's net, whose trees are traced with
``jax.eval_shape`` (``_pair_drawn_by_port``); the other cases draw them in
the reference and carry them over with ``params_from_jax`` (``_pair``;
the cifar fit covers it on a conv tree).

- ResNet-50 (both stems, 32x32x3, 10 classes): the parameter and state
  trees equal the reference's, name for name, with equal shapes and
  dtypes (init only);
- a ResNet-50 forward on the port's weights at 64x64, in training
  mode (the output and the new BatchNorm state) and in eval mode:
  within 1e-4 of the largest magnitude of each (f32 through 53
  convolutions and BNs whose sums both packages take in their own orders;
  f32 itself is 4e-6 off f64 there);
- ``ResNet.cifar(depth=8)``: 3 ``fit`` steps with ``imagenet_optimizer``
  (SGD, momentum 0.9, weight decay 1e-4, warmup: a rate that changes every
  step) against the reference's ``fit``: per-step losses, the parameters'
  changes, the momentum and the BatchNorm state.  f32: losses 1e-5
  relative, the changes and the momentum 1e-4 relative L2 per leaf, the
  state 1e-5; under ``mixed_precision()`` (bf16 compute, f32 masters,
  momentum and state): losses 1e-2, and each leaf's change, momentum and
  moving statistics within twice the distance between the reference's
  own bf16 and f32 runs of that leaf (bf16 rounding is the noise floor:
  measured, the port sits at most 0.99x that distance from the
  reference), and the port's bf16 run at least 0.3x that distance (the
  median over the leaves) from the port's own f32 run, so that it is
  computed in bf16; under ``"dp+f16"`` (f16 compute, no loss scaling in
  either package) the same, each leaf within three times the reference's
  own f16-vs-f32 distance (the CPU's f16 convolutions sum in
  thread-dependent orders);
- ``build_lenet()`` with ``"adam"``: 2 epochs against the reference's
  ``fit`` (losses 1e-5 relative, parameters 1e-5 relative L2);
- ``InferenceModel.predict`` of the trained cifar ResNet (its moving
  statistics) against the reference's, 8 records (a multiple of the
  reference's 8 devices): 1e-5 of the largest probability;
- ResNet-50 served in bf16 within ``RESNET_BF16_SERVE_TOL`` of f32 (224x224,
  1000 classes, moving statistics from one batch), and within
  ``RESNET_BF16_LOGIT_TOL`` of it as logits (``_logit_gap``);
- calibrated int8 ``ResNet.cifar(8)`` served through ``InferenceModel``
  against the reference's calibrated serving: 1e-5 of the largest
  probability.

The ``cuda`` tests hold a conv net's captured train step and captured
request against their eager runs bit for bit, on the card, and the rate a
captured SGD ``update_`` computes there from the count it reads on the
device against the schedule evaluated on the host.  The JAX
package is imported inside the tests that compare with it, so the
``cuda`` tests run without it.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map
from analytics_zoo_tpu_torch.convert import opt_state_from_jax, params_from_jax
from analytics_zoo_tpu_torch.models import ResNet, build_lenet
from analytics_zoo_tpu_torch.parallel import plan as tplan

SEED = 3
FWD_TOL = 1e-4
F32 = dict(loss=1e-5, delta=1e-4, state=1e-5)
BF16 = dict(loss=1e-2)
# the 16-bit runs: each leaf within this many times the reference's own
# 16-bit-vs-f32 distance of that leaf (see the cifar fit test)
SPREAD = {"bf16": 2.0, "f16": 3.0}


@pytest.fixture(autouse=True)
def _restore_contexts():
    saved = engine._CONTEXT
    yield
    engine._CONTEXT = saved
    try:
        import analytics_zoo_tpu.common.engine as jax_engine
        jax_engine._CONTEXT = None
    except ImportError:  # the cuda tests run without the JAX package
        pass


def _jax():
    import jax

    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu import models as jmodels

    return jax, jax_init, jmodels


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree, prefix=""):
    """{path: (shape, dtype name)} of a nest of dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = (tuple(v.shape),
                                    str(v.dtype).replace("torch.", ""))
    return out


def _pairs(t_tree, j_tree, prefix=""):
    """(path, port leaf as numpy, JAX leaf) matched by key."""
    out = []
    for k, v in t_tree.items():
        if isinstance(v, dict):
            out += _pairs(v, j_tree[k], f"{prefix}/{k}")
        else:
            out.append((f"{prefix}/{k}", v.detach().float().numpy(),
                        np.asarray(j_tree[k], np.float32)))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _top(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _pair(build, mesh=None):
    """``build(models)`` in both packages, the port's with the
    reference's weights."""
    jax, jax_init, jmodels = _jax()
    import analytics_zoo_tpu_torch.models as tmodels

    jax_init(seed=SEED, **({"mesh_shape": {"data": mesh}} if mesh else {}))
    init_zoo_context(seed=SEED, device="cpu")
    jnet, tnet = build(jmodels), build(tmodels)
    jnet.build_params()
    tnet.build_params()
    tnet.set_weights(params_from_jax(_np(jnet.params), device="cpu"))
    return jnet, tnet


def _pair_drawn_by_port(build):
    """``build(models)`` in both packages with the port's weights: the
    reference's trees are traced (``jax.eval_shape`` of its
    ``init_params`` and ``init_state``: names, shapes and dtypes, without
    the per-leaf initialiser compiles that its ``build_params`` pays on the
    CPU), checked against the port's, and given the port's values.
    Returns (reference, port, the reference's traced params and state)."""
    jax, jax_init, jmodels = _jax()
    import jax.numpy as jnp

    import analytics_zoo_tpu_torch.models as tmodels

    jax_init(seed=SEED)
    init_zoo_context(seed=SEED, device="cpu")
    jnet, tnet = build(jmodels), build(tmodels)
    tnet.build_params()
    traced = (jax.eval_shape(jnet.init_params, jax.random.PRNGKey(SEED)),
              jax.eval_shape(jnet.init_state))
    assert _paths(tnet.params) == _paths(traced[0])
    assert _paths(tnet.state) == _paths(traced[1])
    jnet.params = tree_map(lambda t: jnp.asarray(t.numpy()), tnet.params)
    jnet.state = tree_map(lambda t: jnp.asarray(t.numpy()), tnet.state)
    return jnet, tnet, traced


@pytest.mark.parametrize("stem", ["7x7", "space_to_depth"])
def test_resnet50_trees_equal_the_reference(stem):
    jnet, tnet, traced = _pair_drawn_by_port(lambda m: m.ResNet.image_net(
        50, classes=10, input_shape=(32, 32, 3), stem=stem))
    assert [ly.name for ly in tnet.layers] == [ly.name for ly in jnet.layers]
    for t_tree, j_tree in ((tnet.params, traced[0]),
                           (tnet.state, traced[1])):
        want = _paths(j_tree)
        got = _paths(t_tree)
        assert got == want
    assert len(_paths(tnet.params)) == 161


def test_resnet50_forward_matches_the_reference():
    """Training mode (the output and the new state), then eval mode with
    moving statistics equal to that batch's, at 64x64.  At 32x32 the last
    stage normalises 1x1 maps over 4 values a channel, and f32 itself is
    3e-4 off f64 there (4e-6 at 64x64): no yardstick."""
    jnet, tnet, _ = _pair_drawn_by_port(lambda m: m.ResNet.image_net(
        50, classes=10, input_shape=(64, 64, 3)))
    x = np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(
        np.float32)
    jy, js = jnet.forward(jnet.params, x, state=jnet.state, training=True)
    with torch.no_grad():
        ty, ts = tnet.forward(tnet.params, torch.from_numpy(x),
                              state=tnet.state, training=True)
    assert _top(ty.numpy(), jy) <= FWD_TOL
    for path, a, b in _pairs(ts, js):
        assert _top(a, b) <= FWD_TOL, path
    # moving statistics = this batch's (new = 0.99 old + 0.01 batch after
    # one step): not the initial (0, 1), under which 50 layers saturate
    # the softmax
    old = _np(jnet.state)
    batch = {k: {n: (np.asarray(v[n]) - 0.99 * old[k][n]) / 0.01
                 for n in v} for k, v in _np(js).items()}
    jy, _ = jnet.forward(jnet.params, x, state=batch, training=False)
    with torch.no_grad():
        ty, _ = tnet.forward(tnet.params, torch.from_numpy(x),
                             state=params_from_jax(batch, device="cpu"),
                             training=False)
    assert np.asarray(jy).max() < 0.99  # not saturated
    assert _top(ty.numpy(), jy) <= FWD_TOL
    np.testing.assert_allclose(ty.sum(-1).numpy(), 1.0, rtol=1e-5)


def _cifar_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    return x, rng.integers(0, 10, n).astype(np.int32)


def _sgd(models):
    # the recipe with a warmup of two steps, so the rate is 0, then half,
    # then all of 0.1 across the three steps
    return models.ResNet.imagenet_optimizer(base_lr=0.4, batch_size=64,
                                            steps_per_epoch=1,
                                            warmup_epochs=2)


_CIFAR_F32: dict = {}


def _cifar_f32(tmp_path):
    """``_cifar_fits("f32")``, run once a process: every case of the fit
    test reads it (the 16-bit cases as their yardstick)."""
    if "fits" not in _CIFAR_F32:
        _CIFAR_F32["fits"] = _cifar_fits("f32", tmp_path)
    return _CIFAR_F32["fits"]


def _cifar_fits(precision, tmp_path):
    """The cifar ResNet from the same weights, 3 steps of ``fit`` in each
    package (``precision`` "f32", "bf16": under ``mixed_precision()``, or
    "f16": under ``"dp+f16"``): (the reference's (losses, parameters,
    momentum, state), the port's, the start)."""
    from analytics_zoo_tpu import models as jmodels
    from analytics_zoo_tpu.parallel.plan import mixed_precision as jmp

    import analytics_zoo_tpu_torch.models as tmodels

    jnet, tnet = _pair(lambda m: m.ResNet.cifar(depth=8), mesh=1)
    p0 = tree_map(lambda t: t.numpy().copy(), tnet.params)
    jnet.compile(optimizer=_sgd(jmodels),
                 loss="sparse_categorical_crossentropy")
    tnet.compile(optimizer=_sgd(tmodels),
                 loss="sparse_categorical_crossentropy")
    x, y = _cifar_data(24)
    jnet.set_tensorboard(str(tmp_path), f"cifar_{precision}")
    plans = {"f32": (None, None), "bf16": (jmp(), tplan.mixed_precision()),
             "f16": ("dp+f16", "dp+f16")}[precision]
    jnet.fit(x, y, batch_size=8, nb_epoch=1, plan=plans[0])
    tnet.fit(x, y, batch_size=8, nb_epoch=1, plan=plans[1])
    jlosses = {s: v for s, v, _ in
               jnet._estimator._writers[0].read_scalar("Loss")}
    jstate = opt_state_from_jax(_np(jnet._estimator._opt_state),
                                device="cpu")
    assert int(jstate.count) == 3
    want = (jlosses, _np(jnet.params), _np(jstate.trace), _np(jnet.state))
    own = tnet._estimator._opt_state
    assert int(own.count) == 3
    assert all(t.dtype == torch.float32 for t in
               tree_leaves(tnet.params) + tree_leaves(own.trace)
               + tree_leaves(tnet.state))
    got = (dict(tnet._estimator.loss_log), tnet.params, own.trace,
           tnet.state)
    return want, got, p0


@pytest.mark.parametrize("mixed", ["f32", "bf16", "f16"],
                         ids=["f32", "bf16", "f16"])
def test_cifar_resnet_fit_matches_the_reference(mixed, tmp_path):
    """f32: fixed tolerances.  bf16 (``mixed_precision()``) and f16
    (``"dp+f16"``, no loss scaling in either package): the port's update
    of each leaf (and its momentum and moving statistics) within twice the
    distance the 16-bit type itself puts between the reference's 16-bit
    and f32 runs of that leaf (two independent roundings differ by ~1.4x
    one; BatchNorm's gamma and beta gradients are sums over 8192 16-bit
    values that mostly cancel, and measured 15-28% apart in either package
    in bf16), the losses within 1e-2; the masters, the momentum and the
    moving statistics stay f32.  In f16 the leaves' distances spread
    wider around that ~1.4x (the CPU's f16 convolutions in either package
    sum in orders that change with the threads: measured up to 2.6x on
    one moving mean, a median of 1.06x over the leaves), so the bound is
    three times it there."""
    want, got, p0 = _cifar_f32(tmp_path) if mixed == "f32" \
        else _cifar_fits(mixed, tmp_path)
    floor, own32, _ = _cifar_f32(tmp_path) if mixed != "f32" \
        else (None, None, None)
    tol = F32 if mixed == "f32" else BF16
    jlosses, tlosses = want[0], got[0]
    assert sorted(tlosses) == sorted(jlosses) == [1, 2, 3]
    for s in jlosses:
        assert tlosses[s] == pytest.approx(jlosses[s], rel=tol["loss"]), s

    def bound(i, path, dist, fixed):
        if floor is None:
            return tol[fixed]
        k, n = path.split("/")[1:]
        return SPREAD[mixed] * dist(want[i][k][n], floor[i][k][n]) + 1e-6

    for path, a, b in _pairs(got[1], want[1]):
        k, n = path.split("/")[1:]
        start = p0[k][n]
        assert _rel(a - start, b - start) <= bound(
            1, path, lambda u, v: _rel(u - start, v - start),
            "delta"), path
    for path, a, b in _pairs(got[2], want[2]):
        assert _rel(a, b) <= bound(2, path, _rel, "delta"), path
    for path, a, b in _pairs(got[3], want[3]):
        assert _top(a, b) <= bound(3, path, _top, "state"), path
    if floor is None:
        return

    # the port's 16-bit run computed in that type: it sits from the port's
    # own f32 run at a median, over the leaves, of at least 0.3x the
    # reference's 16-bit-vs-f32 distance of each leaf (measured in bf16
    # 0.73 for the changes, 0.74 for the momentum, 0.98 for the moving
    # statistics; a run that kept f32 compute would read 0)
    def delta(path):
        k, n = path.split("/")[1:]
        return lambda u, v: _rel(u - p0[k][n], v - p0[k][n])

    for i, dist in ((1, None), (2, _rel), (3, _top)):
        ratios = []
        for (path, a, r), (path32, a32, r32) in zip(
                _pairs(got[i], want[i]), _pairs(own32[i], floor[i])):
            assert path == path32
            d = dist or delta(path)
            ratios.append(d(a, a32) / max(d(r, r32), 1e-30))
        assert np.median(ratios) >= 0.3, (i, sorted(ratios))


def test_lenet_adam_fit_matches_the_reference(tmp_path):
    jnet, tnet = _pair(lambda m: m.build_lenet(), mesh=1)
    for net in (jnet, tnet):
        net.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                    metrics=["accuracy"])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)
    jnet.set_tensorboard(str(tmp_path), "lenet")
    jnet.fit(x, y, batch_size=16, nb_epoch=2)
    tnet.fit(x, y, batch_size=16, nb_epoch=2)
    jlosses = {s: v for s, v, _ in
               jnet._estimator._writers[0].read_scalar("Loss")}
    tlosses = dict(tnet._estimator.loss_log)
    assert sorted(tlosses) == sorted(jlosses) == [1, 2, 3, 4]
    for s in jlosses:
        assert tlosses[s] == pytest.approx(jlosses[s], rel=1e-5), s
    for path, a, b in _pairs(tnet.params, _np(jnet.params)):
        assert _rel(a, b) <= 1e-5, path
    jres = jnet.evaluate(x, y, batch_size=16)
    tres = tnet.evaluate(x, y, batch_size=16)
    assert tres["loss"] == pytest.approx(jres["loss"], rel=1e-5)


def test_inference_model_serves_the_trained_cifar_resnet_as_the_reference():
    from analytics_zoo_tpu.pipeline.inference import InferenceModel as JIM

    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    jnet, tnet = _pair(lambda m: m.ResNet.cifar(depth=8))
    tnet.compile(optimizer=ResNet.imagenet_optimizer(
        base_lr=0.4, batch_size=64, steps_per_epoch=1, warmup_epochs=1),
        loss="sparse_categorical_crossentropy")
    x, y = _cifar_data(16, seed=5)
    tnet.fit(x, y, batch_size=8, nb_epoch=1)
    # the trained weights and moving statistics in the reference
    import jax.numpy as jnp

    jnet.set_weights(tree_map(lambda t: t.numpy(), tnet.params))
    jnet.state = tree_map(lambda t: jnp.asarray(t.numpy()), tnet.state)
    assert float(tnet.state["stem_bn"]["moving_var"].min()) != 1.0
    want = JIM().from_keras_net(jnet).predict(x[:8])
    got = InferenceModel().from_keras_net(tnet).predict(x[:8])
    assert got.shape == (8, 10)
    assert _top(got, want) <= 1e-5
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


# bf16 vs f32 serving of ResNet-50 at 224x224x3, 1000 classes, moving
# statistics from one batch: the largest difference of a probability.
# bf16 rounds every activation to 2**-9 through 53 layers; the JAX
# package's own bf16-vs-f32 gap on this model and batch is 4.6e-3 (the
# port's 6.1e-3), so the bound is about four times the reference's own gap
RESNET_BF16_SERVE_TOL = 0.02
# The largest difference grows with the rows and with the probabilities'
# size: on the H100 (chip_smoke.py, 1, 8 and 32 images) it reads 5.5e-3,
# 8.8e-3 and 1.6e-2 for this model untrained and 1.1e-2 to 1.6e-2 trained,
# so the limit that separates a wrong bf16 forward from bf16's rounding is
# ``_logit_gap``: the rows compared as the logits they come from, relative
# to the logits' spread.  Measured on 8 images of this model on the CPU:
# the JAX package's bf16 0.132-0.143 from its f32, the port's 0.128-0.142
# (and 0.024-0.041 from the JAX package's bf16); on the H100 0.136-0.141
# untrained and 0.061-0.064 trained; serving the initial moving statistics
# instead of the batch's reads 1.86
RESNET_BF16_LOGIT_TOL = 0.3


def _logit_gap(p, q):
    """The largest, over rows, of the L2 distance between the rows'
    log-probabilities, each centred on its mean (the logits up to a row's
    constant), relative to those of ``q``."""
    lp, lq = (np.log(np.maximum(np.asarray(a, np.float64), 1e-30))
              for a in (p, q))
    lp = lp - lp.mean(-1, keepdims=True)
    lq = lq - lq.mean(-1, keepdims=True)
    return float((np.linalg.norm(lp - lq, axis=-1) / np.maximum(
        np.linalg.norm(lq, axis=-1), 1e-30)).max())


def test_resnet50_bf16_serving_within_the_stated_bound_of_f32():
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=SEED, device="cpu")
    net = ResNet.image_net(50)
    net.build_params()
    gen = np.random.default_rng(0)
    recalibrate_batchnorm(net, gen.standard_normal((4, 224, 224, 3),
                                          dtype=np.float32))
    x = gen.standard_normal((2, 224, 224, 3), dtype=np.float32)
    f32 = InferenceModel().from_keras_net(net).predict(x)
    bf16 = InferenceModel().from_keras_net(net).optimize("bf16").predict(x)
    assert f32.shape == bf16.shape == (2, 1000)
    assert np.isfinite(bf16).all()
    np.testing.assert_allclose(bf16.sum(-1), 1.0, atol=1e-2)
    assert float(np.abs(bf16 - f32).max()) <= RESNET_BF16_SERVE_TOL
    assert _logit_gap(bf16, f32) <= RESNET_BF16_LOGIT_TOL


def test_calibrated_int8_of_a_conv_net_raises():
    """Calibrated int8 of a conv net no longer raises: ``ResNet.cifar(8)``
    served by ``InferenceModel.optimize("int8", calibration_data=...)`` on
    the reference's weights equals the reference's calibrated serving
    within 1e-5 of the largest probability (its convs run ``_int8_conv``
    on both sides; an activation can round to the neighbouring int8 step
    where XLA's and PyTorch's float convolutions differ by an ulp: measured
    3e-7); weight-only int8 still serves it."""
    from analytics_zoo_tpu.pipeline.inference import InferenceModel as JIM

    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    jnet, tnet = _pair(lambda m: m.ResNet.cifar(depth=8))
    calib, _ = _cifar_data(16, seed=7)
    x, _ = _cifar_data(8, seed=8)
    want = JIM().from_keras_net(jnet).optimize(
        "int8", calibration_data=calib).predict(x)
    im = InferenceModel().from_keras_net(tnet).optimize(
        "int8", calibration_data=calib)
    got = im.predict(x)
    assert len([n for n in im._int8_model.weights_t
                if n.endswith("_conv")]) == 7
    assert got.shape == (8, 10) and np.isfinite(got).all()
    assert _top(got, want) <= 1e-5
    out = im.optimize("int8").predict(calib)
    assert out.shape == (16, 10) and np.isfinite(out).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_conv_net_captured_step_is_the_eager_step(mixed, cuda_device):
    """``fit``'s captured step (step 1 eager and captured, then replays)
    against ``Estimator.train_step`` called eagerly: losses, parameters,
    momentum and BatchNorm state bit for bit."""
    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.parallel import compile_step
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    plan = tplan.mixed_precision() if mixed else None
    x, y = _cifar_data(32)

    def fresh():
        init_zoo_context(seed=SEED, device="cuda")
        net = ResNet.cifar(depth=8)
        net.build_params()
        net.compile(optimizer=_sgd(__import__(
            "analytics_zoo_tpu_torch.models", fromlist=["ResNet"])),
            loss="sparse_categorical_crossentropy")
        return net

    net = fresh()
    est = net._make_estimator()
    p = est._resolve_plan(plan)
    step = compile_step(est.train_step, p, capture=False)
    params = tree_map(torch.clone, net.params)
    opt, state = est.optimizer.init(params), tree_map(torch.clone,
                                                      net.state)
    casts = est.compute_casts(p, params)
    losses = []
    for i, batch in enumerate(FeatureSet.of(x, y).batches(
            8, shuffle=True, seed=SEED, epoch=1, drop_last=True)):
        params, opt, state, loss = step(
            params, opt, state, engine.step_generator(SEED, i, net.device),
            _to_device(batch, net.device), casts)
        losses.append(loss.item())
    net = fresh()
    net.fit(x, y, batch_size=8, nb_epoch=1, plan=plan)
    got = [v for _, v in net._estimator.loss_log]
    assert got == losses
    for a, b in ((net.params, params), (net._estimator._opt_state, opt),
                 (net.state, state)):
        assert all(torch.equal(u, v) for u, v in zip(tree_leaves(a),
                                                     tree_leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_conv_net_request_replay_is_the_eager_forward(precision,
                                                      cuda_device):
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=SEED, device="cuda")
    net = ResNet.cifar(depth=8)
    net.build_params()
    im = InferenceModel().from_keras_net(net)
    if precision == "bf16":
        im.optimize("bf16")
    x = _cifar_data(8, seed=6)[0]
    first = im.predict(x)   # eager run and capture
    again = im.predict(x)   # replay
    with torch.no_grad():
        eager = im._forward_fn()(im._params, im._state,
                                 [torch.from_numpy(x).to(cuda_device)])
    assert np.array_equal(again, eager.cpu().numpy())
    assert np.array_equal(first, again)


@pytest.mark.cuda
def test_captured_sgd_rate_is_computed_on_the_device(cuda_device):
    """A captured ``update_`` reads the count on the card: with a zero
    trace and parameters and unit gradients, each replay's update is
    -lr(count), the schedule at the count, across the warmup, its end and
    the decay boundaries."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt

    dev = cuda_device
    sched = topt.warmup_epoch_decay(warmup_steps=10, steps_per_epoch=4,
                                    boundaries_epochs=(3, 5), decay=0.1)
    sgd = topt.SGD(lr=0.4, momentum=0.9, weight_decay=1e-4, schedule=sched)
    params = {"w": torch.zeros(256, device=dev)}
    grads = {"w": torch.ones(256, device=dev)}
    state = sgd.in_layout(sgd.init(params))
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sgd.update_({"w": grads["w"].clone()}, state, params)  # warm up
    torch.cuda.current_stream().wait_stream(side)
    static_g = {"w": grads["w"].clone()}
    with torch.cuda.graph(g):
        upd = sgd.update_(static_g, state, params)
    for count in (0, 1, 5, 9, 10, 11, 12, 19, 20, 21, 30):
        state.count.fill_(count)
        state.trace["w"].zero_()
        static_g["w"].copy_(grads["w"])
        g.replay()
        got = upd["w"][0].item()
        want = -0.4 * float(sched(torch.tensor(count, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), count
        assert int(state.count) == count + 1
