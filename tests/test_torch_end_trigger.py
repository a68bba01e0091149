"""``fit``'s end trigger, held against the JAX package's.

Both packages check the end trigger at epoch boundaries only (the JAX
package at the top of its epoch loop), so ``MaxIteration(n)`` with n
inside an epoch trains that epoch to its end.  The same MLP, with the
reference's initial weights carried over by ``params_from_jax``, trains
in both packages on the same seeded data (40 records at batch 8: 5 steps
an epoch; the JAX package's CPU mesh has 8 devices) under
``MaxIteration(n)``: the steps taken and the epoch reached are equal, the
per-step losses agree within 1e-5 relative, and every parameter within
1e-4 of its leaf's largest magnitude (Adam, lr 1e-2, up to 10 steps; the
two packages sum the products in different orders).
"""

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu_torch.convert import params_from_jax

SEED, BATCH, N = 11, 8, 40
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4


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


def _mlp(pkg):
    if pkg == "jax":
        from analytics_zoo_tpu.pipeline.api.keras import Sequential
        from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
        from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam
    else:
        from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
        from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
            Adam,
        )
    net = Sequential()
    net.add(Dense(16, activation="tanh", input_shape=(6,)))
    net.add(Dense(3))
    net.compile(optimizer=Adam(1e-2),
                loss="sparse_categorical_crossentropy_from_logits")
    return net


@pytest.mark.parametrize("n, steps", [(3, 5), (5, 5), (7, 10)])
def test_max_iteration_ends_at_the_epoch_boundary_like_jax(tmp_path, n,
                                                           steps):
    """``MaxIteration(n)``: both packages train ``steps`` steps (whole
    epochs), with the same losses and parameters."""
    from analytics_zoo_tpu.common.triggers import MaxIteration as JMax
    from analytics_zoo_tpu.feature.dataset import FeatureSet as JSet
    from analytics_zoo_tpu_torch.common.triggers import MaxIteration
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet

    rng = np.random.default_rng(4)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    y = rng.integers(0, 3, N).astype(np.int32)
    jnet, tnet = _mlp("jax"), _mlp("torch")
    jnet.build_params()
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    jnet.set_tensorboard(str(tmp_path), "zoo")
    jest, test = jnet._make_estimator(), tnet._make_estimator()
    jnet._estimator, tnet._estimator = jest, test
    jest.train(JSet.of(x, y), batch_size=BATCH, end_trigger=JMax(n))
    test.train(FeatureSet.of(x, y), batch_size=BATCH,
               end_trigger=MaxIteration(n))

    assert test.global_step == jest.global_step == steps
    assert test.epoch == jest.epoch == steps // (N // BATCH) + 1
    # the reference's Loss summaries repeat each epoch's last loss at the
    # epoch boundary's callback, under the same step
    want = {int(s): v for s, v, _ in jest._writers[0].read_scalar("Loss")}
    got = dict(test.loss_log)
    assert len(got) == len(test.loss_log)
    assert sorted(got) == sorted(want) == list(range(1, steps + 1))
    np.testing.assert_allclose([got[i] for i in sorted(got)],
                               [want[i] for i in sorted(want)],
                               rtol=LOSS_RTOL)
    for name, leaves in jnet.params.items():
        for key, want_leaf in leaves.items():
            want_leaf = np.asarray(want_leaf)
            got_leaf = tnet.params[name][key].numpy()
            assert np.abs(got_leaf - want_leaf).max() <= \
                PARAM_TOL * np.abs(want_leaf).max(), (name, key)
