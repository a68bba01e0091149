"""The port's ``ImageClassifier`` against the JAX package's: the same
weights (drawn by the port, carried into the reference as numpy and back
through ``params_from_jax``), the same seeded uint8 images through each
package's default chain (resize, center crop, channel normalize):
``predict_image_set``'s top-k labels equal and its probabilities within
PROB_TOL, for a named family at a small config and for the ``model=net``
form; the configs, ``LabelOutput`` and every family ``build_model`` names
(layer names equal the reference's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.feature.image import ImageSet as JImageSet
from analytics_zoo_tpu.models.image import imageclassification as jic

from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.feature.image import ImageSet
from analytics_zoo_tpu_torch.models.image import imageclassification as tic

SEED = 8
PROB_TOL = 1e-5


@pytest.fixture(autouse=True)
def _contexts(monkeypatch):
    """Both contexts on the CPU from the seed; both packages' channel
    normalize on its numpy path (the port's native one multiplies by the
    reciprocal, so it may differ from a division by an ulp)."""
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu.native as jnative

    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init
    from analytics_zoo_tpu_torch import native

    monkeypatch.setattr(jnative, "lib", None)
    monkeypatch.setattr(native, "lib", None)
    saved = (jax_engine._CONTEXT, torch_engine._CONTEXT,
             torch.get_num_threads())
    torch.set_num_threads(1)
    jax_init(seed=SEED, mesh_shape={"data": 1})
    torch_init(seed=SEED, device="cpu")
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved[:2]
    torch.set_num_threads(saved[2])


def _carry(jclf, tclf, calibrate=None):
    """The port's drawn weights into the reference, and back into the port
    through ``params_from_jax``; the moving statistics set to one batch's
    first, so the softmax is not saturated."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )

    tnet, jnet = tclf.model, jclf.model
    tnet.build_params()
    if calibrate is not None and tnet.state:
        recalibrate_batchnorm(tnet, calibrate)
    weights = tree_map(lambda t: t.numpy(), tnet.params)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, weights)
    jnet.state = tree_map(lambda t: jnp.asarray(t.numpy()), tnet.state)
    tnet.set_weights(params_from_jax(weights, device="cpu"))


def _images(n, h, w, seed=3):
    return np.random.default_rng(seed).integers(
        0, 256, (n, h, w, 3), dtype=np.uint8)


def _same_answers(got, want, top_k):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == top_k
        assert [n for n, _ in g] == [n for n, _ in w]
        assert max(abs(p - q) for (_, p), (_, q) in zip(g, w)) <= PROB_TOL


def test_resnet18_predict_image_set_matches_the_reference():
    config = dict(resize=40, crop=32)
    tclf = tic.ImageClassifier("resnet-18", classes=10,
                               config=tic.ImageClassificationConfig(**config))
    jclf = jic.ImageClassifier("resnet-18", classes=10,
                               config=jic.ImageClassificationConfig(**config))
    assert [ly.name for ly in tclf.model.layers] == \
        [ly.name for ly in jclf.model.layers]
    images = _images(8, 48, 44)
    x = ImageSet.from_arrays(images).transform(
        tclf.config.preprocessing()).to_feature_set().xs[0]
    assert x.shape == (8, 32, 32, 3) and x.dtype == np.float32
    _carry(jclf, tclf, calibrate=x)
    got = tclf.predict_image_set(ImageSet.from_arrays(images), top_k=3,
                                 batch_size=8)
    want = jclf.predict_image_set(JImageSet.from_arrays(images), top_k=3,
                                  batch_size=8)
    _same_answers(got, want, 3)


def test_a_wrapped_net_with_a_grayscale_config_matches_the_reference():
    """``ImageClassifier(model=net)`` over LeNet-5 with a one-channel
    mean/std (the FnPreprocessing normalize), names from a label map."""
    from analytics_zoo_tpu.models.lenet import build_lenet as jlenet

    from analytics_zoo_tpu_torch.models.lenet import build_lenet

    labels = {i: f"digit{i}" for i in range(10)}
    kw = dict(resize=28, crop=28, mean=(0,), std=(255.0,), label_map=labels)
    tclf = tic.ImageClassifier("lenet", model=build_lenet(10),
                               config=tic.ImageClassificationConfig(**kw))
    jclf = jic.ImageClassifier("lenet", model=jlenet(10),
                               config=jic.ImageClassificationConfig(**kw))
    _carry(jclf, tclf)
    images = _images(8, 30, 30, seed=4)[..., :1]
    got = tclf.predict_image_set(ImageSet.from_arrays(images), top_k=5,
                                 batch_size=8)
    want = jclf.predict_image_set(JImageSet.from_arrays(images), top_k=5,
                                  batch_size=8)
    _same_answers(got, want, 5)
    assert got[0][0][0].startswith("digit")


def test_configs_and_label_output_match_the_reference():
    for name in ("resnet-50", "resnet-50-quantize", "alexnet-int8",
                 "inception-v3", "lenet", "unknown-net"):
        t, j = tic.classifier._config_for(name), jic.classifier._config_for(
            name)
        assert (t.resize, t.crop, t.mean, t.std) == \
            (j.resize, j.crop, j.mean, j.std), name
    t, j = tic.ImagenetConfig(299), jic.ImagenetConfig(299)
    assert (t.resize, t.crop, t.mean) == (j.resize, j.crop, j.mean)
    probs = np.random.default_rng(0).dirichlet(np.ones(6), size=3)
    for label_map in (None, {i: f"c{i}" for i in range(6)}):
        assert tic.LabelOutput(label_map, 4)(probs) == \
            jic.LabelOutput(label_map, 4)(probs)


FAMILIES = ["resnet-50", "resnet-50-quantize", "lenet", "inception-v1",
            "inception-v3", "alexnet", "vgg-16", "vgg-19", "densenet-121",
            "densenet-161", "squeezenet", "mobilenet", "mobilenet-v2"]


@pytest.mark.parametrize("name", FAMILIES)
def test_every_family_builds_the_reference_graph(name):
    """The graph each name builds (no weights): the reference's layers, in
    order, under the same names, at the family's config."""
    tnet = tic.ImageClassifier(name, classes=7).model
    jnet = jic.ImageClassifier(name, classes=7).model
    assert [ly.name for ly in tnet.layers] == [ly.name for ly in jnet.layers]
    assert [type(ly).__name__ for ly in tnet.layers] == \
        [type(ly).__name__ for ly in jnet.layers]


def test_an_unknown_family_is_refused_as_by_the_reference():
    for name in ("googlenet", "vgg-11"):
        for mod in (tic, jic):
            with pytest.raises(ValueError, match="unknown model"):
                mod.ImageClassifier(name, classes=3)
