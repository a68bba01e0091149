"""The port's Adam against the JAX package's: the per-leaf formula, the
step scalars, and a 5-step trajectory.

On the CPU the port's update runs the plain version of its CUDA kernel (the
kernel is held against it on a GPU in tests/test_torch_training_kernels.py).
The references are ``optax.adam`` (what the JAX package's ``Adam`` builds)
and the JAX package's ``fused_adam`` with its Pallas kernel in interpret
mode (``ZOO_KERNEL_INTERPRET=1``).  Gradients come from numpy with a seed
and go to both sides each step.  Comparisons are per leaf, in relative L2
norm (where a gradient is ~0 an element's update is ~±lr and its sign may
differ, so an elementwise comparison would be the wrong test):

- against ``fused_adam``, the kernel the port replaces: 1e-6 (the same
  formula in f32);
- against ``optax.adam``: 2e-5.  optax forms 1 - b2 in float64 before
  rounding it to f32, the fused kernel rounds b2 first; at b2 = 0.999 the
  two (1 - b2) differ by 1.3e-5 relative, which moves nu by as much and
  the first update by 6.7e-6 (measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.ops.pallas import fused_adam as jfa
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu_torch.convert import opt_state_from_jax
from analytics_zoo_tpu_torch.ops.cuda import fused_adam as tadam
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt

TOL = 1e-6
OPTAX_TOL = 2e-5
# dict keys out of sorted order: JAX visits them sorted, the port in
# insertion order, so leaves are matched by key
SHAPES = {"a": (300,), "b": {"w": (17, 9), "v": (5,)}, "c": [(130,), (2, 3)]}


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, rng, scale) for v in shapes]
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_plain_leaf_update_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    g, mu = (rng.normal(size=1000).astype(np.float32) for _ in range(2))
    nu = np.abs(rng.normal(size=1000)).astype(np.float32) * 1e-2
    scalars = np.array([1e-3, 0.9, 0.999, 1e-8, 1 - 0.9 ** 4,
                        1 - 0.999 ** 4], np.float32)
    got = tadam.adam_leaf(*(torch.from_numpy(a) for a in (g, mu, nu,
                                                         scalars)))
    ref = jfa._adam_leaf_reference(*(jnp.asarray(a) for a in (g, mu, nu,
                                                              scalars)))
    kernel = jfa._adam_leaf_pallas(*(jnp.asarray(a) for a in (g, mu, nu,
                                                              scalars)),
                                   interpret=True)
    for t, r, k in zip(got, ref, kernel):
        assert _rel(t.numpy(), r) <= TOL and _rel(t.numpy(), k) <= TOL


@pytest.mark.parametrize("count", [0, 1, 9, 999, 2 ** 31 - 1])
def test_step_scalars_match_jax(count):
    """lr at the pre-increment count, bc = 1 - beta^t at the incremented
    one, bit for bit: beta^t is rounded as JAX rounds an f32 raised to an
    int32 power (binary exponentiation), which drifts from the correctly
    rounded power (measured 8e-6 relative at t = 1000), and 1 - beta^t
    magnifies that drift, so the port follows the reference's rounding."""
    sched = topt.warmup_linear_decay(3, 20)
    lr_fn = topt._scheduled(2e-3, sched)
    scalars, inc = tadam.adam_scalars(
        torch.tensor(count, dtype=torch.int32), lr_fn, 0.9, 0.999, 1e-8)
    jc = jnp.asarray(count, jnp.int32)
    jinc = optax.safe_int32_increment(jc)
    jlr = jopt._scheduled(2e-3, jopt.warmup_linear_decay(3, 20))(jc)
    assert int(inc) == int(jinc)
    np.testing.assert_allclose(scalars.numpy()[:4],
                               np.asarray([jlr, 0.9, 0.999, 1e-8],
                                          np.float32), rtol=1e-6)
    for i, beta in ((4, 0.9), (5, 0.999)):
        jax_bc = np.asarray(1.0 - jnp.float32(beta) ** jinc)
        assert scalars[i].item() == float(jax_bc)


@pytest.mark.parametrize("steps", range(0, 13, 3))
def test_schedules_match_jax(steps):
    got = topt.warmup_linear_decay(4, 10)(torch.tensor(steps))
    want = jopt.warmup_linear_decay(4, 10)(jnp.asarray(steps))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("schedule", [None, "warmup"])
def test_trajectory_matches_optax_and_fused_adam(schedule, monkeypatch):
    """5 steps from the same parameters and gradients: parameters,
    updates and both moments per leaf, the count in lockstep."""
    rng = np.random.default_rng(1)
    params = _tree(SHAPES, rng)
    grads = [_tree(SHAPES, rng, 0.1) for _ in range(5)]
    kw = dict(lr=1e-2, schedule=topt.warmup_linear_decay(2, 10)
              if schedule else None)
    port = topt.Adam(**kw)
    jkw = dict(lr=1e-2, schedule=jopt.warmup_linear_decay(2, 10)
               if schedule else None)
    optax_tx = jopt.Adam(**jkw)._tx
    fused_tx = jfa.fused_adam(**jopt.Adam(**jkw).hyperparams)

    tp = _to_torch(params)
    ts = port.init(tp)
    jp = {"optax": jax.tree_util.tree_map(jnp.asarray, params)}
    jp["fused"] = jp["optax"]
    js = {"optax": optax_tx.init(jp["optax"]),
          "fused": fused_tx.init(jp["fused"])}
    monkeypatch.setenv("ZOO_KERNEL_INTERPRET", "1")
    before = jfa.invocation_counts["pallas"]
    for g in grads:
        tu, ts = port.update(_to_torch(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
        for name, tx in (("optax", optax_tx), ("fused", fused_tx)):
            ju, js[name] = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                     js[name], jp[name])
            jp[name] = optax.apply_updates(jp[name], ju)
            tol = TOL if name == "fused" else OPTAX_TOL
            for a, b in zip(_leaves(tu), jax.tree_util.tree_leaves(ju)):
                assert _rel(a.numpy(), b) <= tol
    assert jfa.invocation_counts["pallas"] == before + 5
    for name in ("optax", "fused"):
        tol = TOL if name == "fused" else OPTAX_TOL
        adam = js[name][0]
        assert int(ts.count) == int(adam.count) == 5
        for a, b in zip(_leaves(tp),
                        jax.tree_util.tree_leaves(jp[name])):
            assert _rel(a.numpy(), b) <= tol
        for t_tree, j_tree in ((ts.mu, adam.mu), (ts.nu, adam.nu)):
            for a, b in zip(_leaves(t_tree),
                            jax.tree_util.tree_leaves(j_tree)):
                assert _rel(a.numpy(), b) <= tol


def test_opt_state_from_jax_continues_the_trajectory():
    """optax's state after 3 steps, carried into the port, gives the same
    next step as optax."""
    rng = np.random.default_rng(2)
    params = _tree(SHAPES, rng)
    tx = jopt.Adam(lr=1e-2)._tx
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    for _ in range(3):
        u, js = tx.update(jax.tree_util.tree_map(
            jnp.asarray, _tree(SHAPES, rng, 0.1)), js, jp)
        jp = optax.apply_updates(jp, u)
    state = opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    assert isinstance(state, topt.AdamState) and int(state.count) == 3
    g = _tree(SHAPES, rng, 0.1)
    tu, state = topt.Adam(lr=1e-2).update(_to_torch(g), state,
                                          _to_torch(params))
    ju, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    for a, b in zip(_leaves(tu), jax.tree_util.tree_leaves(ju)):
        assert _rel(a.numpy(), b) <= OPTAX_TOL
    assert int(state.count) == int(js[0].count) == 4
    with pytest.raises(ValueError):
        opt_state_from_jax((optax.EmptyState(),), device="cpu")


def test_get_optimizer():
    assert isinstance(topt.get_optimizer("adam"), topt.Adam)
    opt = topt.Adam(1e-3)
    assert topt.get_optimizer(opt) is opt
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.get_optimizer("rmsprop")
    with pytest.raises(ValueError):
        topt.get_optimizer(3)
