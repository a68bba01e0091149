"""The port's ImageNet classification set against the JAX package's:
Inception-v1/v3 (``models/inception.py``) and every builder of
``models/imagenet_zoo.py``, built in both packages from the same weights
(``params_from_jax``) and fed the same numpy images.

The weights are drawn by the port and handed to the reference as numpy
arrays (its own initialisers compile one program per leaf shape on the
CPU, ~30 s for Inception-v3); its trees are traced with ``jax.eval_shape``
and must equal the port's, name for name, shape for shape.

- Every builder at the toy sizes of ``tests/test_imagenet_zoo.py``
  (Inception-v1 at 32x32, its pool then 1x1; Inception-v3 at 139x139, not
  79: at 79 its last stage normalises 1x1 maps over 8 values a channel,
  where f32 rounding is no yardstick), moving statistics from one batch:
  the probabilities of 8 images within 1e-4 of the reference's largest,
  rows summing to 1; one step of ``fit`` with SGD (momentum 0.9, weight
  decay 1e-4, the sparse cross-entropy on the softmax; dropout off, its
  masks are each package's own): each parameter leaf within 1e-5
  relative L2 of the reference's and its change within 1e-4, each beside
  three times the reference's own f32 order noise of that leaf (its step
  on the batch in another order: up to ~1e-2 of MobileNet's first
  depthwise kernel, where the port's step is within 1e-5 of float64),
  the moving statistics within 1e-5 of each layer's largest.
- Inception-v1 at full width (224x224x3, 1000 classes): the reference's
  leaf names, shapes and dtypes, and its parameter count (about 7.0M).
- Weight-only ``optimize("int8")`` of MobileNet-v2 (224x224x3) quantizes
  exactly the leaves the reference's ``quantize_params`` picks, its 3x3
  depthwise kernels of >= 1024 elements among them, to the same int8
  values and scales.
- bf16 serving within ``LOGIT_TOL`` of f32 by ``_logit_gap`` (the bound
  ``tests/test_torch_conv_models.py`` holds ResNet-50 to), in both
  packages, for Inception-v1 and MobileNet-v2 with moving statistics from
  one batch.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.convert import params_from_jax

SEED = 5
PROB_TOL = 1e-4
STEP_TOL = 1e-5
CHANGE_TOL = 1e-4
# the reference's order noise is one sample of its f32 rounding; the
# port's distance from it is another (measured up to 2.4x on Inception-v3)
NOISE_FACTOR = 3.0
LOGIT_TOL = 0.3


@pytest.fixture(autouse=True)
def _restore_contexts():
    saved = engine._CONTEXT
    yield
    engine._CONTEXT = saved
    import analytics_zoo_tpu.common.engine as jax_engine
    jax_engine._CONTEXT = None


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = (tuple(v.shape),
                                    str(v.dtype).replace("torch.", ""))
    return out


def _pairs(t_tree, j_tree, prefix=""):
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


def _logit_gap(p, q):
    lp, lq = (np.log(np.maximum(np.asarray(a, np.float64), 1e-30))
              for a in (p, q))
    lp = lp - lp.mean(-1, keepdims=True)
    lq = lq - lq.mean(-1, keepdims=True)
    return float((np.linalg.norm(lp - lq, axis=-1) / np.maximum(
        np.linalg.norm(lq, axis=-1), 1e-30)).max())


def _pair(build):
    """``build(inception, imagenet_zoo)`` in both packages with the same
    weights: the trees equal the reference's (its ``init_params`` traced
    with ``jax.eval_shape``), the weights drawn by the port and carried
    into the reference as numpy arrays, and back into the port through
    ``params_from_jax``."""
    import jax
    import jax.numpy as jnp

    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.models import imagenet_zoo as jzoo
    from analytics_zoo_tpu.models import inception as jinc

    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.models import imagenet_zoo as tzoo
    from analytics_zoo_tpu_torch.models import inception as tinc

    jax_init(seed=SEED, mesh_shape={"data": 1})
    init_zoo_context(seed=SEED, device="cpu")
    jnet, tnet = build(jinc, jzoo), build(tinc, tzoo)
    tnet.build_params()
    assert [ly.name for ly in tnet.layers] == [ly.name for ly in jnet.layers]
    shapes = jax.eval_shape(jnet.init_params, jax.random.PRNGKey(SEED))
    assert _paths(tnet.params) == _paths(shapes)
    assert _paths(tnet.state) == _paths(jax.eval_shape(jnet.init_state))
    weights = tree_map(lambda t: t.numpy(), tnet.params)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, weights)
    jnet.state = tree_map(lambda t: jnp.asarray(t.numpy()), tnet.state)
    tnet.set_weights(params_from_jax(weights, device="cpu"))
    return jnet, tnet


# (inception module, imagenet_zoo module) -> model at the reference test's
# toy size, dropout off (its masks are each package's own); input size
BUILDERS = {
    "inception_v1": (lambda i, z: i.Inception.v1(
        classes=5, input_shape=(32, 32, 3), has_dropout=False), 32),
    "inception_v3": (lambda i, z: i.inception_v3(
        classes=5, input_shape=(139, 139, 3), width=0.05,
        has_dropout=False), 139),
    "alexnet": (lambda i, z: z.alexnet(
        classes=5, input_shape=(67, 67, 3), width=0.05, has_dropout=False),
        67),
    "vgg16": (lambda i, z: z.vgg(
        16, classes=5, input_shape=(32, 32, 3), width=0.05,
        has_dropout=False), 32),
    "vgg19": (lambda i, z: z.vgg(
        19, classes=5, input_shape=(32, 32, 3), width=0.05,
        has_dropout=False), 32),
    "squeezenet": (lambda i, z: z.squeezenet(
        classes=5, input_shape=(64, 64, 3), width=0.25), 64),
    "densenet": (lambda i, z: z.densenet(
        classes=5, input_shape=(32, 32, 3), block_plan=(2, 2),
        growth_rate=8, init_features=16), 32),
    "mobilenet": (lambda i, z: z.mobilenet(
        classes=5, input_shape=(32, 32, 3), alpha=0.25, has_dropout=False),
        32),
    "mobilenet_v2": (lambda i, z: z.mobilenet_v2(
        classes=5, input_shape=(32, 32, 3), alpha=0.25), 32),
}


def _images(n, size, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _recalibrated(jnet, tnet, size):
    """Both nets with their moving statistics set to one batch's (in the
    port, then copied): at the initial (0, 1) a BatchNorm net's eval
    forward is near constant."""
    import jax.numpy as jnp

    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )

    if tnet.state:
        recalibrate_batchnorm(tnet, _images(8, size, seed=2))
        jnet.state = tree_map(lambda t: jnp.asarray(t.numpy()), tnet.state)


def _order_noise(jnet, x, y, lr, wd, fit_change):
    """Per leaf, how far the reference's own f32 step moves when the batch
    comes in another order: the SGD step from its jitted gradient on the
    images in their given order, against its ``fit`` step (``fit_change``,
    on the shuffled order).  A conv followed by a BatchNorm has a weight
    gradient that is a sum of 10^4-10^5 terms that nearly cancel (the
    output does not change with the kernel's scale), and the order of
    that sum moves the reference's own step by up to ~1e-2 of a leaf
    (MobileNet's first depthwise kernel; the port's step sits within 1e-5
    of a float64 computation there)."""
    import jax
    import jax.numpy as jnp

    from analytics_zoo_tpu.pipeline.api.keras.objectives import get_loss

    loss_fn = get_loss("sparse_categorical_crossentropy")
    start = {k: dict(v) for k, v in jnet.params.items()}

    def loss(p):
        out, _ = jnet.forward(p, jnp.asarray(x), state=jnet.state,
                              training=True)
        return loss_fn.mean(jnp.asarray(y), out, None)

    grads = jax.jit(jax.grad(loss))(start)
    return {f"/{k}/{n}": float(np.linalg.norm(
        -lr * (np.asarray(grads[k][n], np.float64)
               + wd * np.asarray(start[k][n], np.float64))
        - fit_change[f"/{k}/{n}"]))
        for k in start for n in start[k]}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_serves_and_steps_as_the_reference(name):
    """The probabilities, then one SGD step: per leaf, the port's
    parameters within STEP_TOL relative (L2) and its change within
    CHANGE_TOL relative of the reference's, each beside NOISE_FACTOR times
    the reference's own order noise of that leaf (``_order_noise``); the
    moving statistics within STEP_TOL of each layer's largest."""
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import SGD as JSGD

    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    build, size = BUILDERS[name]
    jnet, tnet = _pair(build)
    x = _images(8, size)
    _recalibrated(jnet, tnet, size)
    want = np.asarray(jnet.predict(x, batch_size=8))
    got = tnet.predict(x, batch_size=8)
    assert got.shape == want.shape == (8, 5)
    assert _top(got, want) <= PROB_TOL, name
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)

    lr, wd = 0.05, 1e-4
    y = np.random.default_rng(1).integers(0, 5, 8).astype(np.int32)
    start = {path: b.astype(np.float64)
             for path, _, b in _pairs(tnet.params, _np(jnet.params))}
    jstart = _np(jnet.params)
    jnet.compile(optimizer=JSGD(lr=lr, momentum=0.9, weight_decay=wd),
                 loss="sparse_categorical_crossentropy")
    tnet.compile(optimizer=SGD(lr=lr, momentum=0.9, weight_decay=wd),
                 loss="sparse_categorical_crossentropy")
    jnet.fit(x, y, batch_size=8, nb_epoch=1)
    tnet.fit(x, y, batch_size=8, nb_epoch=1)
    assert int(tnet._estimator._opt_state.count) == 1
    pairs = _pairs(tnet.params, _np(jnet.params))
    fit_change = {path: b - start[path] for path, _, b in pairs}
    jnet.params, after = jstart, jnet.params
    noise = _order_noise(jnet, x, y, lr, wd, fit_change)
    jnet.params = after
    for path, a, b in pairs:
        a, b = a.astype(np.float64), b.astype(np.float64)
        floor = NOISE_FACTOR * noise[path]
        assert np.linalg.norm(a - b) <= STEP_TOL * np.linalg.norm(b) \
            + floor, (name, path, "parameters")
        da, db = a - start[path], b - start[path]
        assert np.linalg.norm(da - db) <= CHANGE_TOL * np.linalg.norm(db) \
            + floor, (name, path, "change")
    for layer in tnet.state:  # a mean that is 0 is judged by the var
        got = np.concatenate([tnet.state[layer][k].numpy().ravel()
                              for k in ("moving_mean", "moving_var")])
        want = np.concatenate([np.asarray(jnet.state[layer][k]).ravel()
                               for k in ("moving_mean", "moving_var")])
        assert _top(got, want) <= STEP_TOL, (name, layer)


def test_inception_v1_full_width_trees_equal_the_reference():
    """Names, shapes and dtypes of every leaf, and the count, against the
    reference's ``init_params`` (traced with ``jax.eval_shape``)."""
    import jax

    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.models.inception import Inception as JInception

    from analytics_zoo_tpu_torch.models import Inception

    jax_init(seed=SEED, mesh_shape={"data": 1})
    init_zoo_context(seed=SEED, device="cpu")
    jnet, tnet = JInception.v1(classes=1000), Inception.v1(classes=1000)
    tnet.build_params()
    want = _paths(jax.eval_shape(jnet.init_params, jax.random.PRNGKey(0)))
    assert _paths(tnet.params) == want
    assert not tnet.state
    n = sum(int(np.prod(s)) for s, _ in want.values())
    assert sum(t.numel() for p in tnet.params.values()
               for t in p.values()) == n
    assert 6.5e6 < n < 7.5e6, n
    assert len(want) == 116  # 57 convs and the classifier, kernel and bias


def test_mobilenet_v2_int8_quantizes_the_reference_leaves():
    from analytics_zoo_tpu.pipeline.inference.quantize import (
        QuantizedTensor as JQ,
    )
    from analytics_zoo_tpu.pipeline.inference.quantize import (
        quantize_params as jquantize,
    )

    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
        QuantizedTensor,
    )

    jnet, tnet = _pair(lambda i, z: z.mobilenet_v2())
    want = jquantize(jnet.params)
    got = InferenceModel().from_keras_net(tnet).optimize("int8")._params
    picked = []
    for layer, leaves in want.items():
        for leaf, q in leaves.items():
            t = got[layer][leaf]
            assert isinstance(t, QuantizedTensor) == isinstance(q, JQ), \
                (layer, leaf)
            if isinstance(q, JQ):
                picked.append((layer, leaf))
                assert np.array_equal(t.values.numpy(), np.asarray(q.values))
                assert np.array_equal(t.scale.numpy(), np.asarray(q.scale))
    depthwise = [p for p in picked if p[1] == "depthwise_kernel"]
    # 3x3 depthwise kernels of >= 1024 elements: 144 channels and up (15
    # of the 17; 32 and 96 channels, 288 and 864 elements, stay float)
    assert len(depthwise) == 15, depthwise
    assert ("block2_1/dw", "depthwise_kernel") not in picked
    assert ("classifier", "kernel") in picked


def _bf16_gaps(jnet, tnet, size, n=4):
    """(port, reference) logit gaps of bf16 serving against f32, the
    moving statistics set to one batch's."""
    from analytics_zoo_tpu.pipeline.inference import InferenceModel as JIM

    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    _recalibrated(jnet, tnet, size)
    x = _images(n, size, seed=3)
    t32 = InferenceModel().from_keras_net(tnet).predict(x)
    t16 = InferenceModel().from_keras_net(tnet).optimize("bf16").predict(x)
    j32 = np.asarray(JIM().from_keras_net(jnet).predict(x))
    j16 = np.asarray(JIM().from_keras_net(jnet).optimize("bf16").predict(x))
    assert _top(t32, j32) <= PROB_TOL
    assert np.isfinite(t16).all()
    np.testing.assert_allclose(t16.sum(-1), 1.0, atol=1e-2)
    return _logit_gap(t16, t32), _logit_gap(j16, j32)


@pytest.mark.parametrize("name", ["inception_v1", "mobilenet_v2"])
def test_bf16_serving_within_the_logit_bound_of_f32(name):
    if name == "inception_v1":
        build, size = (lambda i, z: i.Inception.v1(
            classes=1000, input_shape=(64, 64, 3))), 64
    else:
        build, size = (lambda i, z: z.mobilenet_v2(
            classes=1000, input_shape=(64, 64, 3))), 64
    jnet, tnet = _pair(build)
    port, ref = _bf16_gaps(jnet, tnet, size)
    assert port <= LOGIT_TOL, port
    assert ref <= LOGIT_TOL, ref


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_random_layers_draw_anew_in_each_captured_step(cuda_device):
    """A conv net with every random layer of the surface (SpatialDropout2D,
    GaussianNoise, GaussianDropout, RReLU, SpatialDropout1D through a
    reshape) through ``fit``'s captured step (step 1 eager and captured,
    then replays) against ``Estimator.train_step`` called eagerly, each
    step with its own generators: losses, parameters, momentum and
    BatchNorm state bit for bit, so each replay drew its own masks."""
    from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.parallel import compile_step
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 4, 64).astype(np.int32)

    def fresh():
        init_zoo_context(seed=SEED, device="cuda")
        net = Sequential()
        net.add(L.DepthwiseConvolution2D(3, 3, border_mode="same",
                                         depth_multiplier=4,
                                         input_shape=(16, 16, 3)))
        net.add(L.BatchNormalization())
        net.add(L.RReLU())
        net.add(L.SpatialDropout2D(0.3))
        net.add(L.GaussianNoise(0.1))
        net.add(L.Convolution2D(8, 3, 3, subsample=(2, 2)))
        net.add(L.GaussianDropout(0.2))
        net.add(L.Reshape((-1, 8)))
        net.add(L.SpatialDropout1D(0.2))
        net.add(L.Flatten())
        net.add(L.Dense(4, activation="softmax"))
        net.build_params()
        net.compile(optimizer=SGD(lr=0.05, momentum=0.9),
                    loss="sparse_categorical_crossentropy")
        return net

    net = fresh()
    est = net._make_estimator()
    plan = est._resolve_plan(None)
    step = compile_step(est.train_step, plan, capture=False)
    params = tree_map(torch.clone, net.params)
    opt, state = est.optimizer.init(params), tree_map(torch.clone,
                                                      net.state)
    casts = est.compute_casts(plan, params)
    losses = []
    for i, batch in enumerate(FeatureSet.of(x, y).batches(
            16, shuffle=True, seed=SEED, epoch=1, drop_last=True)):
        params, opt, state, loss = step(
            params, opt, state, engine.step_generator(SEED, i, net.device),
            _to_device(batch, net.device), casts)
        losses.append(loss.item())
    net = fresh()
    net.fit(x, y, batch_size=16, nb_epoch=1)
    assert [v for _, v in net._estimator.loss_log] == losses
    for a, b in ((net.params, params), (net._estimator._opt_state, opt),
                 (net.state, state)):
        assert all(torch.equal(u, v) for u, v in zip(tree_leaves(a),
                                                     tree_leaves(b)))
