"""The port's ``ZooConfig`` and ``init_zoo_context`` against the
reference's contract (``tests/test_config.py``), the profiler knob, the
async checkpoint's round trip and schema version, the eager validation of
each knob, and the raise of each knob of a plane the port does not have
yet, naming its ROADMAP item.

The defaults and validation messages are held against the JAX package's
own ``ZooConfig`` on the same environment.
"""

import dataclasses
import glob
import os
import pickle

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import init_zoo_context
from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.common.engine import (
    UNPORTED_KNOBS,
    ZooConfig,
)
from analytics_zoo_tpu_torch.common.utils import tree_leaves
from analytics_zoo_tpu_torch.ops import cuda as ops_cuda


@pytest.fixture(autouse=True)
def _restore():
    saved = engine._CONTEXT, torch.get_num_threads()
    yield
    engine._CONTEXT = saved[0]
    torch.set_num_threads(saved[1])


def _fit_tiny(nb_epoch=1, n=64, optimizer="sgd", ckpt=None, hidden=0):
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    m = Sequential()
    if hidden:
        m.add(Dense(hidden, activation="tanh", input_shape=(4,)))
    m.add(Dense(2, activation="softmax", input_shape=(4,)))
    m.compile(optimizer=optimizer, loss="sparse_categorical_crossentropy")
    if ckpt is not None:
        m.set_checkpoint(ckpt)
    m.fit(x, y, batch_size=8, nb_epoch=nb_epoch)
    return m, x, y


def test_zooconfig_from_dict_and_env(monkeypatch):
    monkeypatch.setenv("ZOO_FAILURE_RETRY_TIMES", "2")
    monkeypatch.setenv("ZOO_INFEED_DEPTH", "3")
    ctx = init_zoo_context({"app_name": "t", "seed": 11}, device="cpu")
    assert ctx.config.seed == ctx.seed == 11
    assert ctx.config.app_name == "t"
    assert ctx.config.failure_retry_times == 2   # env tier
    assert ctx.config.infeed_depth == 3
    ctx = init_zoo_context(ZooConfig(failure_retry_times=9), device="cpu")
    assert ctx.config.failure_retry_times == 9   # explicit beats env
    ctx = init_zoo_context("my app", device="cpu")
    assert ctx.config.app_name == "my app" and ctx.seed == 0


def test_unknown_conf_key_rejected():
    with pytest.raises(ValueError, match="unknown conf"):
        init_zoo_context({"not_a_knob": 1}, device="cpu")


def test_explicit_value_beats_env(monkeypatch):
    monkeypatch.setenv("ZOO_FAILURE_RETRY_TIMES", "0")
    ctx = init_zoo_context({"failure_retry_times": 5}, device="cpu")
    assert ctx.config.failure_retry_times == 5
    monkeypatch.setenv("ZOO_STEPS_PER_DISPATCH", "4")
    ctx = init_zoo_context({"steps_per_dispatch": 1}, device="cpu")
    assert ctx.steps_per_dispatch == 1


def test_caller_config_not_mutated():
    cfg = ZooConfig(seed=3)
    ctx = init_zoo_context(cfg, seed=42, device="cpu")
    assert ctx.config.seed == ctx.seed == 42
    assert cfg.seed == 3
    assert ctx.config is not cfg


def test_defaults_match_the_reference(monkeypatch):
    """Every field the reference has, with the reference's resolved
    default (``use_pallas``: the port's unset state is None, its class
    note says why)."""
    from analytics_zoo_tpu.common.engine import ZooConfig as JaxConfig

    for var in list(os.environ):
        if var.startswith("ZOO_"):
            monkeypatch.delenv(var)
    ref, port = JaxConfig(), ZooConfig()
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        if f.name == "use_pallas":
            assert want is False and port.use_pallas is None
        else:
            assert getattr(port, f.name) == want, f.name


INT_KNOBS = [
    ("ZOO_PREFETCH_WORKERS", "prefetch_workers", 0),
    ("ZOO_PREFETCH_DEPTH", "prefetch_depth", 1),
    ("ZOO_STEPS_PER_DISPATCH", "steps_per_dispatch", 1),
    ("ZOO_AUTOTUNE_MAX_WORKERS", "autotune_max_workers", 1),
    ("ZOO_FLEET_MIN_REPLICAS", "fleet_min_replicas", 1),
    ("ZOO_FLEET_LEASE_MS", "fleet_lease_ms", 100),
    ("ZOO_ELASTIC_LEASE_MS", "elastic_lease_ms", 100),
    ("ZOO_ELASTIC_MIN_WORKERS", "elastic_min_workers", 1),
    ("ZOO_ELASTIC_GRACE_MS", "elastic_grace_ms", 0),
]


@pytest.mark.parametrize("var,field,minimum", INT_KNOBS,
                         ids=[k[0] for k in INT_KNOBS])
@pytest.mark.parametrize("raw", ["abc", "1.5", "below"])
def test_integer_knob_is_validated_eagerly(monkeypatch, var, field,
                                           minimum, raw):
    """A non-integer or out-of-range value fails when the config is made,
    naming the env var (or the field), with the reference's message."""
    from analytics_zoo_tpu.common.engine import ZooConfig as JaxConfig

    value = str(minimum - 1) if raw == "below" else raw
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError) as port:
        ZooConfig()
    with pytest.raises(ValueError) as ref:
        JaxConfig()
    assert str(port.value) == str(ref.value)
    assert var in str(port.value)
    monkeypatch.delenv(var)
    with pytest.raises(ValueError, match=f"ZooConfig {field}"):
        ZooConfig(**{field: value})


@pytest.mark.parametrize("var,value", [
    ("ZOO_SHARDING_PLAN", "zero4"), ("ZOO_DTYPE_POLICY", "x=f64"),
    ("ZOO_USE_PALLAS", "maybe"), ("ZOO_AUTOTUNE", "2"),
    ("ZOO_ELASTIC", "perhaps"), ("ZOO_SLO_OBJECTIVE", "1.5"),
    ("ZOO_AUTOTUNE_RAM_BUDGET", "lots"), ("ZOO_DCN_AXIS", " "),
])
def test_other_knobs_are_validated_like_the_reference(monkeypatch, var,
                                                      value):
    from analytics_zoo_tpu.common.engine import ZooConfig as JaxConfig

    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError) as port:
        ZooConfig()
    with pytest.raises(ValueError) as ref:
        JaxConfig()
    assert str(port.value) == str(ref.value)


#: the prefetch and autotune knobs, which raised while their planes were
#: unported: the port reads them now, so their cases check the value is
#: taken (the ids stay the same)
DATA_PLANE_KNOBS = {
    "prefetch_workers": (0, 16), "prefetch_depth": (4, 16),
    "autotune": (False, 16), "autotune_ram_budget": (None, 16),
    "autotune_interval": (0.25, 16), "autotune_max_workers": (None, 16),
}
#: the fleet plane's knobs (items 17 and 18), which raised until the
#: fleet controller, router, admission, scraper and SLO engine were
#: ported: their cases check the value is taken (the ids stay the same)
FLEET_PLANE_KNOBS = {
    "slo_p99_ms": (500.0, 17),
    "fleet_min_replicas": (1, 17), "fleet_max_replicas": (4, 17),
    "fleet_interval": (1.0, 17),
    "admission": (False, 17), "serving_models": (None, 17),
    "scrape_targets": (None, 18), "scrape_interval": (1.0, 18),
    "scrape_stale_after": (10.0, 18), "slo_objective": (0.99, 18),
    "slo_short_window": (30.0, 18), "slo_long_window": (300.0, 18),
    "slo_burn_threshold": (1.0, 18),
}
READ_KNOBS = {**DATA_PLANE_KNOBS, **FLEET_PLANE_KNOBS}
UNPORTED = sorted({**UNPORTED_KNOBS, **READ_KNOBS}.items())


def _other(value):
    if isinstance(value, bool):
        return not value
    if value is None:
        return 2
    return value + 1


def _fleet_reads(cfg, field, value):
    """Where the reference reads a fleet knob, the port's fleet plane
    reads it: the fleet and router ``from_config`` builders."""
    from analytics_zoo_tpu_torch.serving import (
        ClusterServingHelper,
        FleetController,
        InMemoryBroker,
        ModelRouter,
    )

    if field in ("slo_p99_ms", "fleet_min_replicas", "fleet_max_replicas",
                 "fleet_interval"):
        ctrl = FleetController.from_config(
            cfg, ClusterServingHelper(), InMemoryBroker())
        got = {"slo_p99_ms": ctrl.scaler.slo_p99_ms,
               "fleet_min_replicas": ctrl.scaler.min_replicas,
               "fleet_max_replicas": ctrl.scaler.max_replicas,
               "fleet_interval": ctrl.interval}[field]
        assert got == value
    if field in ("serving_models", "admission", "fleet_min_replicas",
                 "fleet_max_replicas", "fleet_interval"):
        cfg.serving_models = cfg.serving_models or "m=100"
        router = ModelRouter.from_config(cfg, InMemoryBroker())
        got = {"serving_models": router.models(),
               "admission": router.admission_enabled,
               "fleet_min_replicas": router.min_replicas,
               "fleet_max_replicas": router.max_replicas,
               "fleet_interval": router.interval}[field]
        assert got == (["bert"] if field == "serving_models" else value)


@pytest.mark.parametrize("field,spec", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_plane_knob_raises_naming_its_item(field, spec):
    off, item = spec
    value = _other(off)
    if field == "serving_models":
        value = "bert=50"
    elif field == "scrape_targets":
        value = "localhost:9100"
    elif field == "dcn_axis":
        value = "dcn"
    elif field == "slo_objective":
        value = 0.5
    elif field == "fleet_min_replicas":
        value = 2
    elif field == "slo_short_window":
        value = 20.0
    init_zoo_context(device="cpu")  # a valid context first
    if field in READ_KNOBS:
        assert field not in UNPORTED_KNOBS
        ctx = init_zoo_context({field: value}, device="cpu")
        assert getattr(ctx.config, field) == value
        if field in FLEET_PLANE_KNOBS:
            _fleet_reads(ctx.config, field, value)
        return
    with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
        init_zoo_context({field: value}, device="cpu")
    # the default value is no request for the plane
    init_zoo_context({field: off}, device="cpu")


@pytest.mark.parametrize("var", ["ZOO_METRICS_PORT", "ZOO_FLIGHT_DIR"])
def test_unported_env_var_raises(monkeypatch, tmp_path, var):
    """These two env vars raised while the metrics plane was unported;
    now the plane reads them: ``init_zoo_context`` accepts them, and the
    port's metrics plane honours each as the reference's does
    (``maybe_start_from_env`` binds the port, ``install`` arms the dump
    directory)."""
    from analytics_zoo_tpu_torch.metrics import flight, http

    monkeypatch.setenv(var, "0" if var.endswith("PORT") else str(tmp_path))
    init_zoo_context(device="cpu")
    if var == "ZOO_METRICS_PORT":
        monkeypatch.setattr(http, "_env_server", None)
        srv = http.maybe_start_from_env()
        assert srv is not None and srv.port > 0
        srv.stop()
    else:
        monkeypatch.setattr(flight, "_default", None)
        rec = flight.get_flight_recorder()
        rec.record("probe", value=1)
        path = rec.dump(reason="probe")
        assert path is not None and path.startswith(str(tmp_path))


def test_a_mesh_of_more_than_one_device_raises():
    init_zoo_context({"mesh_shape": {"data": 1}}, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        init_zoo_context({"mesh_shape": {"data": 2}}, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        init_zoo_context(device="cpu", dcn_shape={"data": 2})


def test_sharding_plan_env_tier(monkeypatch):
    """``ZOO_SHARDING_PLAN`` resolves through ``resolve_plan``: a dp name
    trains under it, a sharded one raises there (item 13)."""
    monkeypatch.setenv("ZOO_SHARDING_PLAN", "dp+bf16")
    init_zoo_context(seed=0, device="cpu")
    m, _, _ = _fit_tiny()
    assert m._estimator._plan_record["name"] == "dp+bf16"
    monkeypatch.setenv("ZOO_SHARDING_PLAN", "zero1")
    init_zoo_context(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        _fit_tiny()
    monkeypatch.delenv("ZOO_SHARDING_PLAN")
    monkeypatch.setenv("ZOO_SHARD_OPTIMIZER", "1")
    init_zoo_context(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        _fit_tiny()


@pytest.mark.parametrize("value,plain", [(None, 1), ("1", 1), ("0", 0)])
def test_use_pallas_zero_is_the_explicit_opt_out(monkeypatch, value, plain):
    """Unset or ``1``: the Adam scope takes the port's route (on the CPU
    its plain version, counted); ``0``: the ``"xla"`` rule, which moves no
    counter."""
    if value is not None:
        monkeypatch.setenv("ZOO_USE_PALLAS", value)
    init_zoo_context(seed=0, device="cpu")
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam

    before = fused_adam.plain_count
    _fit_tiny(optimizer="adam", hidden=64)  # a leaf of 256 elements
    assert (fused_adam.plain_count > before) == bool(plain)
    assert "fused_adam" in ops_cuda.kernel_invocation_counts()


def test_profiler_knob_writes_trace(tmp_path):
    prof = str(tmp_path / "prof")
    init_zoo_context(ZooConfig(profile_dir=prof, profile_steps=2),
                     device="cpu")
    _fit_tiny(nb_epoch=2)
    traces = glob.glob(os.path.join(prof, "**", "*.trace.json.gz"),
                       recursive=True)
    assert traces, f"no trace under {prof}"


def test_profiler_fires_with_tiny_epochs(tmp_path):
    """3-step epochs: the trace is armed per estimator, not per epoch."""
    prof = str(tmp_path / "prof2")
    init_zoo_context(ZooConfig(profile_dir=prof, profile_steps=2),
                     device="cpu")
    _fit_tiny(nb_epoch=4, n=24)
    assert glob.glob(os.path.join(prof, "**", "*.trace.json.gz"),
                     recursive=True)


@pytest.mark.parametrize("async_ckpt", ["1", "0"])
def test_async_checkpoint_roundtrip(tmp_path, monkeypatch, async_ckpt):
    """A fresh model on the directory resumes the saved state: with the
    absolute target reached the fit trains nothing, and evaluates as the
    trained model does."""
    monkeypatch.setenv("ZOO_ASYNC_CHECKPOINT", async_ckpt)
    init_zoo_context(seed=0, device="cpu")
    ck = str(tmp_path / "ck")
    m, x, y = _fit_tiny(nb_epoch=3, ckpt=ck)
    ref = m.evaluate(x, y, batch_size=8)
    assert glob.glob(os.path.join(ck, "ckpt-*.pkl"))
    est = m._estimator._ckpt
    assert len(est.stall_seconds) == len(est.write_seconds) == 3
    m2, _, _ = _fit_tiny(nb_epoch=3, ckpt=ck)
    assert m2._estimator.global_step == 24 and not m2._estimator.loss_log
    assert m2.evaluate(x, y, batch_size=8)["loss"] == pytest.approx(
        ref["loss"], abs=1e-6)


def test_checkpoint_schema_version(tmp_path):
    """Snapshots carry ``format_version`` 1; a snapshot with no meta
    loads as version 0, a newer one is refused."""
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _Checkpointer,
    )

    ck = _Checkpointer(str(tmp_path / "ck"))
    ck.save("0000", {"params": {"w": torch.ones(2)}, "step": 3})
    ck._wait()
    with open(ck.list()[-1], "rb") as f:
        raw = pickle.load(f)
    assert raw["__ckpt_meta__"]["format_version"] == 1
    got = ck.latest()
    assert "__ckpt_meta__" not in got and got["step"] == 3
    np.testing.assert_array_equal(got["params"]["w"], np.ones(2))
    legacy = str(tmp_path / "ck" / "ckpt-0001.pkl")
    with open(legacy, "wb") as f:
        pickle.dump({"step": 9}, f)
    assert ck.latest()["step"] == 9
    future = str(tmp_path / "ck" / "ckpt-0002.pkl")
    with open(future, "wb") as f:
        pickle.dump({"__ckpt_meta__": {"format_version": 99}, "step": 1}, f)
    with pytest.raises(ValueError, match="format_version"):
        ck.latest()


@pytest.mark.parametrize("depth", ["1", "4"])
def test_infeed_depth_keeps_the_trajectory(monkeypatch, depth):
    """``ZOO_INFEED_DEPTH``: the feeder thread runs that many dispatches
    ahead; the losses and weights are those of the default depth (2), bit
    for bit."""
    torch.set_num_threads(1)
    init_zoo_context(seed=0, device="cpu")
    want, _, _ = _fit_tiny(nb_epoch=2, optimizer="adam", hidden=8)
    monkeypatch.setenv("ZOO_INFEED_DEPTH", depth)
    ctx = init_zoo_context(seed=0, device="cpu")
    assert ctx.config.infeed_depth == int(depth)
    got, _, _ = _fit_tiny(nb_epoch=2, optimizer="adam", hidden=8)
    assert got._estimator.loss_log == want._estimator.loss_log
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)
