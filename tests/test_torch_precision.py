"""The port's precision plane and mixed-precision training against the JAX
package's.

The same numpy inputs and weights (``params_from_jax``) go through both
packages:

- ``match_rule_values`` and ``cast_params_for_compute``: bit for bit (the
  uint16 patterns of every bf16 and f16 leaf), with the scalar exemption,
  the ``int8`` -> bf16 training role and the ``keep`` role; the masters
  stay untouched;
- ``compute_cast_dtype`` for each canned policy, and ``ZOO_DTYPE_POLICY``:
  validated when the context is made, overlaid on a plan without dtype
  rules, beaten by an explicit plan;
- ``fit`` under ``mixed_precision()`` on the JAX test's Dense probe and on
  a 2-block BERT (hidden 128, head dim 64, sequence 256, dropout 0; the
  flash route, the reference's Pallas kernels in interpret mode): per-step
  losses within 1e-2 relative (bf16 rounds each stored activation to
  2**-9 relative, and the two packages' CPU kernels round different
  partial sums; measured 1.0e-3 and 2.4e-3), the same plan record, f32 masters and Adam moments, and
  ``evaluate`` after the fit on the reference's trained weights, which
  computes in f32 in both packages (1e-5 relative; in bf16 it would be
  ~1e-3 off);
- the bf16 and f16 flash forward with its (m, l) statistics and the
  16-bit backward (B1 H2 L256 D64): the port's plain versions against the
  reference's ``_flash_fwd_pallas`` and ``_flash_bwd_pallas`` in interpret
  mode.  (m, l) within 1e-5 relative (f32 sums of exact products of
  16-bit inputs); the output and gradients within 1e-2 (bf16) and 2e-3
  (f16) of each tensor's largest magnitude (both compute in f32 and round
  the results to the input type, so f32 sums in another order can land
  one step apart: 2**-8 relative in bf16, measured at most 1.1e-3; 2**-11
  in f16).
- f16 on the card: every kernel's dtype check takes it (``KERNEL_DTYPES``
  and the wrappers' checks, before any library is loaded), so nothing
  refuses an f16 plan;
- the dtype policy in ``fit``: ``ZOO_DTYPE_POLICY`` overlaid on a plan
  without dtype rules and beaten by an explicit one, the same plan records
  and losses as the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map_many
from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.parallel import plan as tplan
from analytics_zoo_tpu_torch.parallel.partition import match_rule_values

LOSS_RTOL = 1e-2
EVAL_RTOL = 1e-5
FLASH_STATS_RTOL = 1e-5
FLASH_BF16_TOL = 1e-2
FLASH_F16_TOL = 2e-3


@pytest.fixture(autouse=True)
def _restore_contexts():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine

    saved = jax_engine._CONTEXT, torch_engine._CONTEXT
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved


def _jplan():
    from analytics_zoo_tpu.parallel import plan as jplan

    return jplan


def _bits(a):
    """A leaf's bit pattern as numpy (uint16 for bf16/f16), and its
    dtype's name."""
    if torch.is_tensor(a):
        name = str(a.dtype).replace("torch.", "")
        if a.dtype in (torch.bfloat16, torch.float16):
            return a.view(torch.int16).numpy().view(np.uint16), name
        return a.numpy(), name
    a = np.asarray(a)
    name = {"float16": "float16", "bfloat16": "bfloat16"}.get(
        a.dtype.name, a.dtype.name)
    if a.dtype.itemsize == 2 and a.dtype.kind != "i":
        return a.view(np.uint16), name
    return a, name


def _tree():
    gen = np.random.default_rng(5)
    return {"dense_0": {"kernel": gen.normal(size=(8, 16)).astype(np.float32),
                        "bias": gen.normal(size=(16,)).astype(np.float32)},
            "blocks": [{"qkv_kernel": gen.normal(size=(16, 48)).astype(
                np.float32), "ln_gamma": np.ones((16,), np.float32)}],
            "embed": gen.normal(size=(10, 16)).astype(np.float32),
            "scale": np.float32(0.5) * np.ones((), np.float32),
            "one": np.full((1,), 3.0, np.float32),
            "ids": np.arange(6, dtype=np.int32)}


RULES = {
    "bf16_mixed": "bf16_mixed",
    "int8_serving": "int8_serving",
    "f16": ".*=f16",
    "keep_and_mixed": r"embed=keep,blocks/\d+/ln_=f32,dense_0/kernel=int8,"
                      r"_bias$=f16,.*=bf16",
}


@pytest.mark.parametrize("policy", sorted(RULES))
def test_cast_params_for_compute_is_bitwise_the_references(policy):
    jplan = _jplan()
    from analytics_zoo_tpu.parallel.partition import (
        match_rule_values as jmatch,
    )

    tree = _tree()
    tparams = params_from_jax(tree, device="cpu")
    tp = tplan.with_dtype_policy(tplan.data_parallel(), RULES[policy])
    jp = jplan.with_dtype_policy(jplan.data_parallel(), RULES[policy])
    assert tp.name == jp.name and tp.dtype_rules == jp.dtype_rules
    assert match_rule_values(tp.dtype_rules, tparams, default="f32") == \
        jmatch(jp.dtype_rules, tree, default="f32")
    masters = [t.clone() for t in tree_leaves(tparams)]
    got = tp.cast_params_for_compute(tparams)
    want = jp.cast_params_for_compute(
        jax.tree_util.tree_map(jnp.asarray, tree))
    dtypes = []

    def check(g, w):
        (gb, gname), (wb, wname) = _bits(g), _bits(w)
        assert gname == wname
        np.testing.assert_array_equal(gb, wb)
        dtypes.append(gname)

    tree_map_many(check, got, want)
    # masters untouched: same dtype, same values
    for a, b in zip(tree_leaves(tparams), masters):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the scalar and size-1 leaves keep their width under every rule
    assert got["scale"].dtype == got["one"].dtype == torch.float32
    assert got["ids"].dtype == torch.int32
    assert {"bfloat16", "float16"} & set(dtypes)


@pytest.mark.parametrize("policy", ["f32", "bf16_mixed", "int8_serving",
                                    ".*=f16", "embed=keep,.*=f16",
                                    "a=f32,b=int8,.*=f16"])
def test_compute_cast_dtype_matches_reference(policy):
    jplan = _jplan()
    got = tplan.with_dtype_policy(tplan.data_parallel(),
                                  policy).compute_cast_dtype()
    want = jplan.with_dtype_policy(jplan.data_parallel(),
                                   policy).compute_cast_dtype()
    if want is None:
        assert got is None
    else:
        assert str(got).replace("torch.", "") == jnp.dtype(want).name


def test_zoo_dtype_policy_is_validated_when_the_context_is_made(
        monkeypatch):
    from analytics_zoo_tpu.common.engine import ZooConfig
    from analytics_zoo_tpu_torch import init_zoo_context

    monkeypatch.setenv("ZOO_DTYPE_POLICY", "bf17")
    for make in (ZooConfig, lambda: init_zoo_context(device="cpu")):
        with pytest.raises(ValueError, match="ZOO_DTYPE_POLICY"):
            make()
    for policy in ("bf16_mixed", "auto", r"embed=keep,.*=bf16"):
        monkeypatch.setenv("ZOO_DTYPE_POLICY", policy)
        assert init_zoo_context(device="cpu").dtype_policy == \
            ZooConfig().dtype_policy == policy
    # the explicit tier is ``fit(plan=...)``:
    # test_dtype_policy_in_fit_matches_jax
    monkeypatch.delenv("ZOO_DTYPE_POLICY")
    assert init_zoo_context(device="cpu").dtype_policy is None


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _probe_data():
    gen = np.random.default_rng(0)
    x = gen.normal(size=(256, 8)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(8, 4))
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


def _probe(keras, layers):
    m = keras.Sequential()
    m.add(layers.Dense(16, activation="relu", input_shape=(8,)))
    m.add(layers.Dense(4, activation="softmax"))
    return m


def _pair(build, mesh=None):
    """The same model in both packages, the port's with the reference's
    weights."""
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jk
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu_torch import init_zoo_context as torch_init
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    jax_init(seed=3, **({"mesh_shape": {"data": mesh}} if mesh else {}))
    torch_init(seed=3, device="cpu")
    jnet, tnet = build(jk, jl), build(tk, tl)
    jnet.build_params()
    tnet.build_params()
    tnet.set_weights(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    return jnet, tnet


def _check_trained_like_reference(jnet, tnet, steps):
    """Per-step losses, the plan record, f32 masters and moments."""
    jlosses = {s: v for s, v, _ in
               jnet._estimator._writers[0].read_scalar("Loss")}
    tlosses = dict(tnet._estimator.loss_log)
    assert sorted(tlosses) == sorted(jlosses) == list(range(1, steps + 1))
    for s in jlosses:
        assert tlosses[s] == pytest.approx(jlosses[s], rel=LOSS_RTOL), s
    assert tnet._estimator._plan_record == {
        k: jnet._estimator._plan_record[k] for k in ("name", "dtype_policy")}
    assert all(t.dtype == torch.float32 for t in tree_leaves(tnet.params))
    own = tnet._estimator._opt_state
    assert all(t.dtype == torch.float32
               for t in tree_leaves(own.mu) + tree_leaves(own.nu))


def _check_evaluates_like_reference(jnet, tnet, x, y, batch):
    """``evaluate`` after the fit, on the reference's trained weights:
    the estimator's own plan (``dp``, f32) in both packages, not the
    fit's."""
    tnet.set_weights(jax.tree_util.tree_map(np.asarray, jnet.params))
    assert tnet.evaluate(x, y, batch_size=batch)["loss"] == pytest.approx(
        jnet.evaluate(x, y, batch_size=batch)["loss"], rel=EVAL_RTOL)


@pytest.mark.parametrize("plan", [None, "dp+f16", "dp+kernels"])
def test_dtype_policy_in_fit_matches_jax(plan, monkeypatch, tmp_path):
    """``ZOO_DTYPE_POLICY=bf16_mixed``: overlaid on a plan without dtype
    rules (``dp``, ``dp+kernels``), beaten by an explicit dtype role."""
    monkeypatch.setenv("ZOO_DTYPE_POLICY", "bf16_mixed")
    monkeypatch.setenv("ZOO_KERNEL_INTERPRET", "1")
    x, y = _probe_data()
    jnet, tnet = _pair(_probe, mesh=2)
    for net in (jnet, tnet):
        net.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jnet.set_tensorboard(str(tmp_path), "policy")
    jnet.fit(x, y, batch_size=32, nb_epoch=1, plan=plan)
    tnet.fit(x, y, batch_size=32, nb_epoch=1, plan=plan)
    _check_trained_like_reference(jnet, tnet, 8)
    want = {None: "dp+bf16", "dp+f16": "dp+f16",
            "dp+kernels": "dp+kernels+bf16"}[plan]
    assert tnet._estimator._plan_record["name"] == want


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a wrapper's checks see
    for a CUDA tensor, on a machine that has none."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_f16_compute_on_the_card_is_refused_before_a_step(monkeypatch):
    """Nothing refuses f16 on the card any more: every compute dtype a plan
    or ``ZOO_COMPUTE_DTYPE`` can name is in ``KERNEL_DTYPES``, the
    estimator has no dtype check left, and the flash, cross-entropy and
    int8 wrappers' checks take f16 CUDA tensors before any kernel library
    is loaded (they still refuse f64)."""
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as tfa
    from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as txent
    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as tim
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator

    assert torch.float16 in tfa.KERNEL_DTYPES
    ctx = init_zoo_context(seed=3, device="cpu", compute_dtype="f16")
    assert ctx.compute_dtype == torch.float16 in tfa.KERNEL_DTYPES
    for plan in ("dp+f16", "dp+f16+kernels", "dp+bf16", "dp",
                 tplan.with_dtype_policy(tplan.resolve_plan("dp"),
                                         ".*=f16")):
        dtype = tplan.resolve_plan(plan).compute_cast_dtype()
        assert dtype is None or dtype in tfa.KERNEL_DTYPES
    assert not hasattr(Estimator, "_check_compute_dtype")

    def no_library(*a):
        raise AssertionError("a kernel library was loaded")

    for mod in (tfa, txent, tim):
        monkeypatch.setattr(mod, "_library", no_library)
    for dtype in (torch.float16, torch.bfloat16, torch.float32):
        q = _OnCuda(torch.zeros(1, 2, 128, 64, dtype=dtype))
        tfa._check_cuda(q, q, q)
        txent._check(_OnCuda(torch.zeros(8, 2, dtype=dtype)),
                     _OnCuda(torch.zeros(8, dtype=torch.int64)))
        tim._check(_OnCuda(torch.zeros(8, 64, dtype=dtype)),
                   _OnCuda(torch.zeros(64, 16, dtype=torch.int8)),
                   _OnCuda(torch.zeros(16)))
    q = _OnCuda(torch.zeros(1, 2, 128, 64, dtype=torch.float64))
    with pytest.raises(TypeError, match="float16"):
        tfa._check_cuda(q, q, q)
    with pytest.raises(TypeError, match="float16"):
        txent._check(_OnCuda(torch.zeros(8, 2, dtype=torch.float64)),
                     _OnCuda(torch.zeros(8, dtype=torch.int64)))
    with pytest.raises(TypeError, match="f16"):
        tim._check(_OnCuda(torch.zeros(8, 64, dtype=torch.float64)),
                   _OnCuda(torch.zeros(64, 16, dtype=torch.int8)),
                   _OnCuda(torch.zeros(16)))


def test_fit_mixed_precision_dense_probe_matches_jax(tmp_path):
    from analytics_zoo_tpu.parallel.plan import mixed_precision as jmp

    x, y = _probe_data()
    jnet, tnet = _pair(_probe, mesh=2)
    for net in (jnet, tnet):
        net.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jnet.set_tensorboard(str(tmp_path), "mp")
    jnet.fit(x, y, batch_size=32, nb_epoch=2, plan=jmp())
    tnet.fit(x, y, batch_size=32, nb_epoch=2, plan=tplan.mixed_precision())
    _check_trained_like_reference(jnet, tnet, 16)
    assert tnet._estimator._plan_record == {"name": "dp+bf16",
                                            "dtype_policy": ".*=bf16"}
    _check_evaluates_like_reference(jnet, tnet, x, y, 32)


VOCAB, HIDDEN, SEQ = 100, 128, 256


def _bert(keras, layers):
    ins = [keras.Input((SEQ,)) for _ in range(4)]
    _, pooled = layers.BERT(
        vocab=VOCAB, hidden_size=HIDDEN, n_block=2, n_head=2, seq_len=SEQ,
        intermediate_size=256, hidden_p_drop=0.0, attn_p_drop=0.0)(ins)
    return keras.Model(ins, layers.Dense(2)(pooled))


def _bert_data(n):
    gen = np.random.default_rng(1)
    ids = gen.integers(0, VOCAB, (n, SEQ)).astype(np.int32)
    types = gen.integers(0, 2, (n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    lengths = gen.integers(SEQ // 4, SEQ + 1, n)
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.float32)
    return [ids, types, pos, mask], gen.integers(0, 2, n).astype(np.int32)


def test_fit_mixed_precision_bert_matches_jax(monkeypatch, tmp_path):
    """Two steps of a 2-block BERT under ``mixed_precision()``: attention
    on the flash route in bf16 in both packages."""
    from analytics_zoo_tpu.ops.pallas import flash_attention as jfa
    from analytics_zoo_tpu.parallel.plan import mixed_precision as jmp
    from analytics_zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.ops.cuda import kernel_invocation_counts
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    loss = "sparse_categorical_crossentropy_from_logits"
    x, y = _bert_data(16)
    jnet, tnet = _pair(_bert)
    jnet.compile(optimizer=JAdam(1e-3), loss=loss)
    tnet.compile(optimizer=Adam(1e-3), loss=loss)
    jnet.set_tensorboard(str(tmp_path), "bert")
    pallas = jfa.invocation_counts["pallas"]
    jnet.fit(x, y, batch_size=8, nb_epoch=1, plan=jmp())
    assert jfa.invocation_counts["pallas"] > pallas
    before = kernel_invocation_counts()["flash_attention_fwd"]["plain"]
    tnet.fit(x, y, batch_size=8, nb_epoch=1, plan=tplan.mixed_precision())
    # 2 blocks x 2 steps through the flash route's plain version
    assert kernel_invocation_counts()["flash_attention_fwd"]["plain"] \
        == before + 4
    _check_trained_like_reference(jnet, tnet, 2)
    _check_evaluates_like_reference(jnet, tnet, x, y, 8)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", FLASH_BF16_TOL),
                                       ("float16", FLASH_F16_TOL)],
                         ids=["bf16", "f16"])
def test_flash_bf16_forward_stats_and_backward_match_jax(dtype, tol,
                                                         monkeypatch):
    """16-bit q, k, v, a padding bias and dropout 0.1 (the hash is the same
    in both packages): the forward with (m, l) and dq, dk, dv, the
    backward through the reference's ``_flash_bwd_pallas``."""
    from analytics_zoo_tpu.ops.pallas import flash_attention as jfa
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as tfa

    monkeypatch.setenv("ZOO_FLASH_INTERPRET", "1")
    b, h, n, d, p = 1, 2, 256, 64, 0.1
    gen = np.random.default_rng(4)
    q, k, v, g = (gen.normal(size=(b, h, n, d)).astype(np.float32)
                  for _ in range(4))
    keep = np.arange(n) < 200
    bias = np.where(keep, 0.0, np.finfo(np.float32).min).astype(
        np.float32)[None, None, None, :]
    seed = np.array([-1234567, 987654321], np.int32)
    jq, jk, jv, jg = (jnp.asarray(a, getattr(jnp, dtype))
                      for a in (q, k, v, g))
    tq, tk, tv, tg = (params_from_jax(np.asarray(a), device="cpu")
                      for a in (jq, jk, jv, jg))
    scale = 1.0 / np.sqrt(d)

    want = jfa._flash_fwd_pallas(jq, jk, jv, False, scale, 128, 128,
                                 interpret=True, bias=jnp.asarray(bias),
                                 dropout_p=p, seed=jnp.asarray(seed),
                                 return_stats=True)
    got = tfa.attention_reference(tq, tk, tv, False, scale,
                                  torch.from_numpy(bias), p,
                                  tfa.normalize_seed(seed),
                                  return_stats=True)
    assert got[0].dtype == getattr(torch, dtype) \
        and want[0].dtype == getattr(jnp, dtype)
    _close(got[0], want[0], tol)
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                   rtol=FLASH_STATS_RTOL)

    def jax_fn(q, k, v):
        return jfa.flash_attention(q, k, v, False, None, 128, 128,
                                   bias=jnp.asarray(bias), dropout_p=p,
                                   dropout_seed=jnp.asarray(seed))

    before = jfa.invocation_counts["pallas"]
    jout, vjp = jax.vjp(jax_fn, jq, jk, jv)
    jgrads = vjp(jg)
    assert jfa.invocation_counts["pallas"] >= before + 2  # fwd and bwd
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, False, None,
                              bias=torch.from_numpy(bias), dropout_p=p,
                              dropout_seed=seed)
    out.backward(tg)
    _close(out.detach(), jout, tol)
    for t, w in zip(leaves, jgrads):
        assert t.grad.dtype == getattr(torch, dtype)
        _close(t.grad, w, tol)


def _close(got, want, tol):
    """Every element within ``tol`` of the reference's largest
    magnitude."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
