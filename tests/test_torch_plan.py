"""The port's kernel and precision planes against the JAX package's.

Twins of the rule-table cases of ``tests/test_precision.py`` and
``tests/test_kernels.py``, run on both packages where the port has the
piece: validation errors, first-match resolution, plan names and suffixes,
named dtype policies, and the path -> role map over the same BERT tree.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.parallel import plan as tplan
from analytics_zoo_tpu_torch.parallel.partition import (
    leaf_path_name,
    tree_map_with_path,
)


def _jplan():
    from analytics_zoo_tpu.parallel import plan as jplan

    return jplan


@pytest.fixture(params=["torch", "jax"])
def P(request):
    """The plan module of either package: the cases below hold for both."""
    return tplan if request.param == "torch" else _jplan()


def test_invalid_rules_raise_at_construction(P):
    with pytest.raises(ValueError, match="role"):
        P.ShardingPlan(name="t", dtype_rules=((".*", "f8"),))
    with pytest.raises(ValueError, match="kernel"):
        P.ShardingPlan(name="t", kernel_rules=((".*", "turbo"),))
    with pytest.raises(ValueError, match="dtype role"):
        P.with_dtype(P.data_parallel(), "f8")


def test_error_text_matches_the_reference():
    jplan = _jplan()
    for kw in ({"dtype_rules": ((".*", "f8"),)},
               {"kernel_rules": ((".*", "turbo"),)}):
        msgs = []
        for mod in (tplan, jplan):
            with pytest.raises(ValueError) as e:
                mod.ShardingPlan(name="t", **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_first_match_wins_and_scalars_exempt(P):
    plan = P.ShardingPlan(
        name="t", dtype_rules=((r"dense_0/kernel", "f32"), (r".*", "bf16")))
    tree = {"dense_0": {"kernel": np.zeros((4, 4), np.float32),
                        "bias": np.zeros((4,), np.float32)},
            "step": np.zeros((), np.float32)}
    if P is tplan:
        tree = tree_map_with_path(lambda _, a: torch.from_numpy(a), tree)
    roles = plan.dtype_roles(tree)
    assert roles == {"dense_0/kernel": "f32", "dense_0/bias": "bf16"}


def test_kernel_for_first_match_and_default(P):
    plan = P.ShardingPlan(
        name="t", kernel_rules=((r"^attention$", "xla"), (r".*", "flash")))
    assert plan.kernel_for("attention") == "xla"
    assert plan.kernel_for("anything.else") == "flash"
    assert "attention" in plan.kernel_policy_str()
    # None defers to the later rules
    deferring = P.ShardingPlan(
        name="d", kernel_rules=((r"attention", None), (r".*", "xla")))
    assert deferring.kernel_for("attention") == "xla"
    assert deferring.kernel_policy_str() == "attention=defer,.*=xla"
    empty = P.ShardingPlan(name="e")
    assert empty.kernel_policy_str() == ""
    assert empty.kernel_for("attention") is None
    assert empty.kernel_for("attention", default="xla") == "xla"


def test_resolve_kernel_innermost_plan_and_defaults(P):
    assert P.resolve_kernel("optimizer.adam") is None
    assert P.resolve_kernel("attention", default="flash") == "flash"
    outer = P.ShardingPlan(
        name="o", kernel_rules=((r"^optimizer\.adam$", "fused_adam"),
                                (r"^attention$", "xla")))
    inner = P.ShardingPlan(
        name="i", kernel_rules=((r"^attention$", "flash"),
                                (r"^loss", None)))
    with P._active_plan(outer):
        assert P.resolve_kernel("optimizer.adam") == "fused_adam"
        # "xla" is an explicit pick, not a fall-through
        assert P.resolve_kernel("attention", default="flash") == "xla"
        assert P.resolve_kernel("loss.softmax_xent") is None
        with P._active_plan(inner):
            assert P.resolve_kernel("attention") == "flash"
            # the inner plan has no pick for adam: the outer one decides
            assert P.resolve_kernel("optimizer.adam") == "fused_adam"
            assert P.resolve_kernel("loss.softmax_xent") is None
        assert P.resolve_kernel("attention") == "xla"
    assert P.resolve_kernel("attention") is None


def test_with_kernels_naming_and_tables(P):
    dp = P.data_parallel()
    wk = P.with_kernels(dp)
    assert wk.name == "dp+kernels"
    assert [k for _, k in wk.kernel_rules] == \
        [k for _, k in P.DEFAULT_KERNEL_RULES]
    assert dp.cache_key() != wk.cache_key()
    assert P.with_kernels(dp, rules=((".*", "xla"),)).cache_key() \
        != wk.cache_key()
    assert P.with_kernels(wk).name == "dp+kernels"
    assert P.int8_serving().dtype_rules == ((".*", "int8"),)
    assert P.int8_serving().name == "dp+int8"
    xla = P.with_kernels(P.int8_serving(), (("serving.int8_matmul", "xla"),))
    assert xla.name == "dp+int8+kernels"
    assert xla.kernel_for("serving.int8_matmul") == "xla"
    assert P.mixed_precision().name == "dp+bf16"


def test_named_tables_are_the_reference_tables():
    jplan = _jplan()
    for name in ("DTYPE_ROLES", "DTYPE_POLICY_NAMES", "KERNEL_NAMES",
                 "DEFAULT_KERNEL_RULES"):
        assert getattr(tplan, name) == getattr(jplan, name), name


@pytest.mark.parametrize("spec", [
    None, "", "f32", "none", "bf16_mixed", "int8_serving",
    "dense_0/kernel=f32,.*=bf16", "blocks=keep, .*=int8",
    ((".*", "f16"),),
])
def test_resolve_dtype_rules_matches_reference(spec):
    jplan = _jplan()
    assert tplan.resolve_dtype_rules(spec) == jplan.resolve_dtype_rules(spec)
    base = tplan.data_parallel()
    got = tplan.with_dtype_policy(base, spec)
    want = jplan.with_dtype_policy(jplan.data_parallel(), spec)
    assert (got.name, got.dtype_rules) == (want.name, want.dtype_rules)


@pytest.mark.parametrize("spec", ["auto", "x=f8", "no_equals_sign",
                                  ((".*", "f8"),)])
def test_resolve_dtype_rules_rejects_like_reference(spec):
    jplan = _jplan()
    for mod in (tplan, jplan):
        with pytest.raises(ValueError):
            mod.resolve_dtype_rules(spec)


@pytest.mark.parametrize("name", ["dp", "data_parallel", "none", "dp+f32",
                                  "dp+bf16", "dp+int8", "dp+kernels",
                                  "dp+int8+kernels", "dp+bf16+kernels"])
def test_resolve_plan_round_trips(name):
    jplan = _jplan()
    got, want = tplan.resolve_plan(name), jplan.resolve_plan(name)
    assert (got.name, got.dtype_rules, got.kernel_rules) == \
        (want.name, want.dtype_rules, want.kernel_rules)
    # a plan's name resolves back to the same plan
    again = tplan.resolve_plan(got.name)
    assert again.cache_key() == got.cache_key()
    assert got.dtype_policy_str() == want.dtype_policy_str()
    assert got.kernel_policy_str() == want.kernel_policy_str()
    assert tplan.resolve_plan(got) is got
    assert tplan.resolve_plan(None).name == "dp"


@pytest.mark.parametrize("name", ["zero1", "zero2", "zero3", "fsdp",
                                  "fsdp+overlap", "zero1+bf16+kernels"])
def test_sharded_names_raise(name):
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        tplan.resolve_plan(name)


@pytest.mark.parametrize("name", ["auto", "dp+overlap", "tp", "zero9"])
def test_bad_names_raise_value_error_like_reference(name):
    for mod in (tplan, _jplan()):
        with pytest.raises(ValueError):
            mod.resolve_plan(name)


def test_compile_step_runs_under_the_plan():
    plan = tplan.with_kernels(tplan.data_parallel(),
                              (("attention", "xla"),))
    step = tplan.compile_step(
        lambda a, b=0: (a + b, tplan.resolve_kernel("attention")), plan)
    assert step.label == "dp+kernels_step" and step.plan is plan
    assert step(1, b=2) == (3, "xla")
    assert tplan.resolve_kernel("attention") is None
    assert tplan.compile_step(lambda: 0, label="x").plan.name == "dp"


def test_active_plan_is_per_thread():
    import threading

    plan = tplan.with_kernels(tplan.data_parallel())
    seen = []
    with tplan._active_plan(plan):
        t = threading.Thread(
            target=lambda: seen.append(tplan.resolve_kernel("attention")))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert tplan.resolve_kernel("attention") == "flash"
    assert seen == [None]


def test_leaf_path_name_matches_reference():
    from analytics_zoo_tpu.parallel.partition import (
        leaf_path_name as jax_name,
    )

    tree = {"a": [{"w": np.zeros(2)}, {"w": np.zeros(2), "b": (1, 2)}],
            "c": np.zeros(3)}
    got, want = [], []
    tree_map_with_path(lambda p, _: got.append(leaf_path_name(p)), tree)
    jax.tree_util.tree_map_with_path(
        lambda p, _: want.append(jax_name(p)), tree)
    assert sorted(got) == sorted(want)
    assert "a/1/b/0" in got


def _bert_trees():
    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.pipeline.api import keras as jk
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu_torch.pipeline.api import keras as tk
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl

    def build(keras, layers):
        ins = [keras.Input((64,)) for _ in range(4)]
        _, pooled = layers.BERT(vocab=50, hidden_size=64, n_block=2,
                                n_head=1, seq_len=64,
                                intermediate_size=128)(ins)
        return keras.Model(ins, layers.Dense(2)(pooled))

    jax_init(seed=0)
    jnet = build(jk, jl)
    jnet.build_params()
    tnet = build(tk, tl)
    tnet.build_params(rng=torch.Generator().manual_seed(0), device="cpu")
    return jnet.params, tnet.params


@pytest.mark.parametrize("rules", [
    ((".*", "int8"),),
    ((r"blocks/\d+/(qkv|fc)_kernel", "int8"), (r"embed", None),
     (r"_bias$", "bf16"), (r"pooler", "f16")),
])
def test_dtype_roles_on_the_bert_tree_match_reference(rules):
    import analytics_zoo_tpu.common.engine as jax_engine

    jplan = _jplan()
    saved = jax_engine._CONTEXT
    try:
        jparams, tparams = _bert_trees()
    finally:
        jax_engine._CONTEXT = saved
    got = tplan.ShardingPlan(name="t", dtype_rules=rules).dtype_roles(
        tparams)
    want = jplan.ShardingPlan(name="t", dtype_rules=rules).dtype_roles(
        jparams)
    assert got == want and len(got) > 10
