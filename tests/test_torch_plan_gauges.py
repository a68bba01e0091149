"""The planes' gauge families (``parallel/plan.py``'s
``record_dtype_gauges`` and ``record_kernel_gauges``) against the JAX
package's: the same families, help strings, labels and values for the same
parameter tree and plan, and the estimator publishing them at the start of
a fit, as the reference's does."""

import importlib

import numpy as np
import pytest

PACKAGES = ("analytics_zoo_tpu", "analytics_zoo_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _tree(pkg):
    gen = np.random.default_rng(0)
    tree = {"dense_0": {"kernel": gen.normal(size=(12, 8)),
                        "bias": np.zeros(8)},
            "embedding": {"table": gen.normal(size=(30, 4))},
            "ln": {"gamma": np.ones(4)}}
    tree = {k: {n: v.astype(np.float32) for n, v in d.items()}
            for k, d in tree.items()}
    if pkg == PACKAGES[0]:
        import jax.numpy as jnp

        return {k: {n: jnp.asarray(v) for n, v in d.items()}
                for k, d in tree.items()}
    import torch

    return {k: {n: torch.from_numpy(v) for n, v in d.items()}
            for k, d in tree.items()}


def _with_registry(pkg, fn):
    reg_mod = _mod(pkg, "metrics.registry")
    reg = reg_mod.MetricsRegistry()
    old = reg_mod.set_registry(reg)
    try:
        out = fn()
    finally:
        reg_mod.set_registry(old)
    samples = _mod(pkg, "metrics.merge").registry_samples(reg)
    families = {(s["name"], s.get("help")) for s in samples}
    return out, sorted((s["name"], sorted((s.get("labels") or {}).items()),
                        s.get("value")) for s in samples), sorted(families)


@pytest.mark.parametrize("policy", ["mixed_precision", "int8_serving",
                                    "f16"])
def test_dtype_gauges_match_the_reference(policy):
    def run(pkg):
        plan_mod = _mod(pkg, "parallel.plan")
        if policy == "f16":
            plan = plan_mod.with_dtype(plan_mod.data_parallel(), "f16",
                                       r"kernel|table")
        else:
            plan = getattr(plan_mod, policy)()
        return _with_registry(pkg, lambda: plan_mod.record_dtype_gauges(
            "train_step_x", plan, _tree(pkg)))

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref
    assert ref[0]["compute_bytes"] < ref[0]["master_bytes"]


def test_kernel_gauges_match_the_reference():
    def run(pkg):
        plan_mod = _mod(pkg, "parallel.plan")
        plan = plan_mod.with_kernels(plan_mod.mixed_precision())
        out, samples, families = _with_registry(
            pkg, lambda: plan_mod.record_kernel_gauges("train_step_x", plan))
        selections = [s for s in samples if s[0] == "zoo_kernel_selections"]
        return (out["selections"], selections, plan_mod.KERNEL_SCOPES,
                [f for f in families if f[0] == "zoo_kernel_selections"])

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref
    assert set(port[0]) == set(port[2])


def test_kernel_invocation_gauges_re_export_the_counters():
    """``zoo_kernel_invocations{kernel, backend}``: ``kernel`` counts the
    CUDA kernel's launches and ``plain`` its plain version's calls, read
    from ``ops.cuda.kernel_invocation_counts()``."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import (
        flash_attention,
        kernel_invocation_counts,
    )
    from analytics_zoo_tpu_torch.parallel.plan import (
        data_parallel,
        record_kernel_gauges,
    )

    q = torch.randn(1, 2, 128, 64)
    flash_attention.flash_attention(q, q, q)
    out, samples, _ = _with_registry(
        PACKAGES[1], lambda: record_kernel_gauges("serving", data_parallel()))
    assert out["selections"] == {}  # no kernel rules: no selections
    counts = kernel_invocation_counts()
    assert out["invocations"] == counts
    got = {(dict(labels)["kernel"], dict(labels)["backend"]): value
           for name, labels, value in samples
           if name == "zoo_kernel_invocations"}
    assert got[("flash_attention_fwd", "plain")] == \
        counts["flash_attention_fwd"]["plain"] >= 1
    assert got[("flash_attention_fwd", "kernel")] == \
        counts["flash_attention_fwd"]["kernel"]


def test_fit_publishes_the_plan_gauges():
    """A fit under a plan with dtype and kernel rules publishes both
    families under ``train_step_<plan>``, where the reference publishes
    them (with its memory gauges, before the first step)."""
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu_torch.common.engine import init_zoo_context
    from analytics_zoo_tpu_torch.parallel.plan import (
        mixed_precision,
        with_kernels,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    saved = torch_engine._CONTEXT
    init_zoo_context(seed=1, device="cpu")
    try:
        m = Sequential()
        m.add(Dense(4, activation="softmax", input_shape=(6,)))
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
        gen = np.random.default_rng(2)
        x = gen.normal(size=(16, 6)).astype(np.float32)
        y = gen.integers(0, 4, 16).astype(np.int32)
        plan = with_kernels(mixed_precision())

        def fit():
            m.fit(x, y, batch_size=8, nb_epoch=1, plan=plan)

        _, samples, _ = _with_registry(PACKAGES[1], fit)
    finally:
        torch_engine._CONTEXT = saved
    label = f"train_step_{plan.name}"
    names = {(n, dict(lab).get("label")) for n, lab, _ in samples}
    for family in ("zoo_dtype_leaves", "zoo_dtype_compute_bytes",
                   "zoo_dtype_bytes_ratio", "zoo_kernel_selections"):
        assert (family, label) in names, family
    assert any(n == "zoo_kernel_invocations" for n, _, _ in samples)


def test_a_replica_sets_its_gauges_as_it_is_scraped():
    """A fleet replica's ``MetricsServer`` runs its collect hook as a
    scrape is served: ``/telemetryz`` reads the launches made up to that
    scrape, with no thread publishing between scrapes."""
    import json
    import urllib.request

    import torch

    from analytics_zoo_tpu_torch.metrics import MetricsServer
    from analytics_zoo_tpu_torch.metrics import registry as reg_mod
    from analytics_zoo_tpu_torch.ops.cuda import (
        flash_attention,
        kernel_invocation_counts,
    )
    from analytics_zoo_tpu_torch.serving.fleet import _replica_gauges

    def plain_launches(url):
        with urllib.request.urlopen(url + "/telemetryz", timeout=10) as r:
            samples = json.loads(r.read().decode())["samples"]
        return [s["value"] for s in samples
                if s["name"] == "zoo_kernel_invocations"
                and s["labels"] == {"kernel": "flash_attention_fwd",
                                    "backend": "plain"}]

    old = reg_mod.set_registry(reg_mod.MetricsRegistry())
    srv = MetricsServer(port=0, collect=_replica_gauges()).start()
    try:
        q = torch.randn(1, 2, 128, 64)
        flash_attention.flash_attention(q, q, q)
        first = plain_launches(srv.url)
        flash_attention.flash_attention(q, q, q)
        second = plain_launches(srv.url)
        count = kernel_invocation_counts()["flash_attention_fwd"]["plain"]
    finally:
        srv.stop()
        reg_mod.set_registry(old)
    assert first == [count - 1] and second == [count]
