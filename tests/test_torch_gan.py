"""The port's GANEstimator against the JAX package's.

From the JAX package's initial groups, the same phase-steps on the same
data (Adam on both groups, two discriminator phases to one generator
phase) leave both groups within 1e-5 of the reference's, each group's
optimizer having counted only its own phases.  A checkpoint written by
either package samples the same images in the other.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu import init_zoo_context as jax_context
from analytics_zoo_tpu.tfpark.gan import GANEstimator as JaxGAN
from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.convert import gan_groups_from_jax
from analytics_zoo_tpu_torch.tfpark import GANEstimator

STEPS, D_STEPS, G_STEPS = 7, 2, 1
rng0 = np.random.default_rng(0)
NOISE = rng0.normal(size=(64, 3)).astype(np.float32)
REAL = (rng0.normal(size=(64, 2)) * 0.5 + 1.0).astype(np.float32)


def _nets(pkg):
    layers = __import__(f"{pkg}.pipeline.api.keras.layers", fromlist=["x"])

    def generator_fn(z):
        return layers.Dense(2)(layers.Dense(5, activation="tanh")(z))

    def discriminator_fn(x):
        return layers.Dense(1)(layers.Dense(4, activation="tanh")(x))

    return generator_fn, discriminator_fn


def _jax_gan(model_dir):
    g, d = _nets("analytics_zoo_tpu")
    return JaxGAN(g, d, lambda f: jnp.mean(-f),
                  lambda r, f: jnp.mean(jnp.square(f) - r),
                  "adam", "adam", generator_steps=G_STEPS,
                  discriminator_steps=D_STEPS, model_dir=model_dir)


def _port_gan(model_dir):
    g, d = _nets("analytics_zoo_tpu_torch")
    return GANEstimator(g, d, lambda f: torch.mean(-f),
                        lambda r, f: torch.mean(torch.square(f) - r),
                        "adam", "adam", generator_steps=G_STEPS,
                        discriminator_steps=D_STEPS, model_dir=model_dir)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One JAX run: its initial groups, trained groups, counts, samples."""
    jax_context(seed=42)
    md = str(tmp_path_factory.mktemp("jax_gan"))
    est = _jax_gan(md)
    est._ensure_built((3,), (2,), jax.random.PRNGKey(42))
    initial = {"gp": _np(est._gp), "dp": _np(est._dp), "gs": _np(est._gs),
               "ds": _np(est._ds)}
    est.train((NOISE, REAL), steps=STEPS, batch_size=32)
    return {"dir": md, "initial": initial,
            "gp": _np(est._gp), "dp": _np(est._dp),
            "counts": (int(est._d_opt_state[0].count),
                       int(est._g_opt_state[0].count)),
            "samples": np.asarray(est.generate(NOISE)), "step": est.step}


@pytest.fixture(autouse=True)
def _cpu():
    init_zoo_context(seed=42, device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    return tree.detach().numpy() if torch.is_tensor(tree) else tree


def test_phase_steps_match_reference(reference, tmp_path):
    est = _port_gan(str(tmp_path))
    est._ensure_built((3,), (2,))
    groups = gan_groups_from_jax(reference["initial"], "cpu")
    est._gp, est._dp = groups["gp"], groups["dp"]
    est._gs, est._ds = groups["gs"], groups["ds"]
    est.train((NOISE, REAL), steps=STEPS, batch_size=32)
    assert est.step == reference["step"] == STEPS
    # each group's Adam counted its own phases only: 5 d, 2 g
    counts = (int(est._d_opt_state.count), int(est._g_opt_state.count))
    assert counts == reference["counts"] == (5, 2)
    assert [est.is_d_phase(s) for s in range(STEPS)] == \
        [True, True, False, True, True, False, True]
    assert len(est.losses) == STEPS and np.all(np.isfinite(est.losses))
    for group in ("gp", "dp"):
        got = _leaves(getattr(est, f"_{group}"))
        for name, layer in reference[group].items():
            for k, want in layer.items():
                np.testing.assert_allclose(got[name][k], want, atol=1e-5,
                                           rtol=1e-5, err_msg=f"{name}/{k}")
    np.testing.assert_allclose(est.generate(NOISE), reference["samples"],
                               atol=1e-5)


def test_checkpoints_load_in_either_package(reference, tmp_path):
    # the reference's checkpoint, sampled by a fresh port estimator
    est = _port_gan(reference["dir"])
    np.testing.assert_allclose(est.generate(NOISE), reference["samples"],
                               atol=1e-5)
    assert est.step == STEPS
    # training after generate() builds the discriminator, as the reference
    est.train((NOISE, REAL), steps=STEPS + 2, batch_size=32)
    assert est.step == STEPS + 2 and est.disc_net is not None
    # the port's checkpoint, sampled by a fresh JAX estimator
    mine = est.generate(NOISE)
    jax_context(seed=42)
    jest = _jax_gan(str(os.path.dirname(est.checkpoint_path)))
    np.testing.assert_allclose(np.asarray(jest.generate(NOISE)), mine,
                               atol=1e-5)
    assert jest.step == STEPS + 2
    with pytest.raises(ValueError, match="batch_size"):
        est.train((NOISE[:8], REAL[:8]), steps=STEPS + 3, batch_size=32)
