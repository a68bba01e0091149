"""The port's admission controller and multi-tenant router
(``serving/admission.py``, ``serving/router.py``) against the JAX
package's: the same verdicts for the same broker state under one fake
clock, the same per-model streams and decision logs, and the typed
rejection at the front door."""

import importlib

import numpy as np
import pytest

PACKAGES = ("analytics_zoo_tpu", "analytics_zoo_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _Clock:
    """Stands in for the admission module's ``time``: a tick a step."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


class _Engine:
    def __init__(self):
        self.names = []

    def firing(self):
        return [{"slo": n, "firing": True} for n in self.names]


#: (stream length, broker memory ratio, firing SLO alerts) a step
STEPS = [(0, 0.0, ()), (10, 0.0, ()), (45, 0.1, ()), (60, 0.1, ()),
         (55, 0.1, ()), (30, 0.1, ()), (20, 0.1, ()), (12, 0.45, ()),
         (8, 0.2, ("predict_latency",)), (8, 0.2, ("step_time",)),
         (4, 0.2, ()), (0, 0.0, ()), (70, 0.0, ()), (70, 0.0, ()),
         (0, 0.0, ())]


def _admission_run(pkg, monkeypatch, **kwargs):
    adm_mod = _mod(pkg, "serving.admission")
    broker_mod = _mod(pkg, "serving.broker")
    client = _mod(pkg, "serving.client")
    clock = _Clock()
    monkeypatch.setattr(adm_mod, "time", clock)

    class Broker(broker_mod.InMemoryBroker):
        mem = 0.0

        def memory_ratio(self):
            return self.mem

    db = Broker()
    stream = client.model_stream("m")
    eng = _Engine()
    adm = adm_mod.AdmissionController(
        db, stream=stream, model="m", backlog_limit=50, slo_engine=eng,
        **kwargs)
    out = []
    for n, mem, firing in STEPS:
        clock.t += 0.25
        while db.xlen(stream) < n:
            db.xadd(stream, {"i": "0"})
        if db.xlen(stream) > n:
            db.xtrim(stream, n)
        db.mem = mem
        eng.names = list(firing)
        verdict = adm.evaluate()
        try:
            adm.admit("u")
            admitted = "accept"
        except client.ServingRejected as e:
            admitted = (type(e).__name__, e.retry_after_s, e.reason)
        published = db.hgetall(client.ADMISSION_KEY_PREFIX + stream)
        out.append((verdict, admitted, published, adm.state()))
    out.append([{k: v for k, v in d.items() if k != "ts"}
                for d in adm.decision_log()])
    out.append(adm.current())
    adm.stop()
    out.append(db.hgetall(client.ADMISSION_KEY_PREFIX + stream))
    return out


@pytest.mark.parametrize("kwargs", [{}, {"slo_names": ["predict_latency"],
                                         "resume_ratio": 0.2}],
                         ids=["all_slos", "named_slo"])
def test_admission_verdicts_match_the_reference(kwargs, monkeypatch):
    ref, port = [_admission_run(p, monkeypatch, **kwargs) for p in PACKAGES]
    assert port == ref
    reasons = {v[0]["reason"] for v in ref[:len(STEPS)]}
    assert {"backlog", "draining", "broker_pressure"} <= reasons
    assert any(r.startswith("slo_burn:") for r in reasons)


def test_admission_validation_matches_the_reference():
    bad = [dict(backlog_limit=0), dict(memory_high=0.0),
           dict(memory_high=1.5), dict(resume_ratio=0.0)]

    def run(pkg):
        adm_mod = _mod(pkg, "serving.admission")
        db = _mod(pkg, "serving.broker").InMemoryBroker()
        out = [adm_mod.DEFAULT_MEMORY_HIGH, adm_mod.DEFAULT_RESUME_RATIO]
        for kw in bad:
            with pytest.raises(ValueError) as e:
                adm_mod.AdmissionController(db, **kw)
            out.append(str(e.value))
        return out

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref


def test_a_client_is_refused_by_the_published_verdict():
    """A shed verdict published by the port's controller stops a port
    client at enqueue with the typed ``ServingRejected``, before the record
    enters the stream."""
    from analytics_zoo_tpu_torch.serving import (
        InMemoryBroker,
        InputQueue,
        ServingRejected,
    )
    from analytics_zoo_tpu_torch.serving.admission import AdmissionController
    from analytics_zoo_tpu_torch.serving.client import model_stream

    db = InMemoryBroker()
    adm = AdmissionController(db, stream=model_stream("m"), model="m",
                              backlog_limit=2)
    inq = InputQueue(broker=db, model="m")
    inq.enqueue("a", np.zeros(3, np.float32))
    inq.enqueue("b", np.zeros(3, np.float32))
    assert adm.evaluate()["state"] == "shed"
    with pytest.raises(ServingRejected) as e:
        inq.enqueue("c", np.zeros(3, np.float32))
    assert e.value.reason == "backlog" and e.value.retry_after_s > 0
    assert db.xlen(model_stream("m")) == 2
    adm.stop()
    inq.enqueue("c", np.zeros(3, np.float32))  # the verdict is cleared


def _router_run(pkg, tmp_path):
    """Two tenants over one broker in thread mode, ticked by hand."""
    serving = _mod(pkg, "serving")
    fleet = _mod(pkg, "serving.fleet")
    client = _mod(pkg, "serving.client")
    db = serving.InMemoryBroker()
    log = str(tmp_path / f"{pkg}.log")
    router = serving.ModelRouter(
        db, "resnet=250@120,bert=500@30",
        model_factory=lambda spec: fleet._SyntheticModel(0.0),
        helper_factory=lambda spec, verdict: serving.ClusterServingHelper(
            batch_size=4, batch_budget_ms=5, lease_ms=5000,
            log_dir=str(tmp_path / pkg)),
        admission=True, min_replicas=1, max_replicas=2, interval=3600.0,
        fleet_interval=3600.0, serve_log=log,
        admission_kwargs={"backlog_limit": 1000, "interval": 3600.0})
    router.start()
    out = {"models": router.models()}
    try:
        out["streams"] = {m: router.tenant(m).stream
                          for m in router.models()}
        out["scalers"] = {m: (router.controller(m).scaler.slo_p99_ms,
                              router.controller(m).trim,
                              router.admission(m) is not None,
                              router.verdict(m))
                          for m in router.models()}
        for m in router.models():
            inq = serving.InputQueue(broker=db, model=m)
            for i in range(6):
                inq.enqueue(f"{m}-{i}", np.zeros((3,), np.float32))
        outq = serving.OutputQueue(broker=db)
        got = {}
        import time

        deadline = time.time() + 60
        while len(got) < 12 and time.time() < deadline:
            got.update(outq.dequeue())
            time.sleep(0.01)
        out["answered"] = sorted(got)
        router.tick()
        cur = router.current()
        out["current"] = {m: {k: v for k, v in d.items()
                              if k not in ("admission",)}
                          for m, d in cur["models"].items()}
        out["flags"] = (cur["admission"], cur["mode"])
        with pytest.raises(KeyError) as e:
            router.tenant("nope")
        out["missing"] = str(e.value)
    finally:
        router.stop()
    out["decisions"] = [{k: v for k, v in d.items() if k != "ts"}
                        for d in router.decision_log()]
    out["verdict_keys"] = sorted(k for k in db.keys(
        client.ADMISSION_KEY_PREFIX))
    lines = [ln.split() for ln in open(log).read().splitlines()]
    out["served"] = sorted(u for _, u in lines)
    return out


def test_router_streams_and_decisions_match_the_reference(tmp_path):
    ref, port = [_router_run(p, tmp_path) for p in PACKAGES]
    assert port == ref
    assert port["served"] == port["answered"]  # exactly once each
    assert len(port["served"]) == 12
    assert port["streams"] == {"resnet": "model_stream:resnet",
                               "bert": "model_stream:bert"}
    assert [d["action"] for d in port["decisions"]] == \
        ["start", "start", "stop", "stop"]
    assert port["verdict_keys"] == []  # stop clears the front doors


def test_router_from_config_and_the_oracle_raise():
    from analytics_zoo_tpu_torch.common.engine import ZooConfig
    from analytics_zoo_tpu_torch.serving import InMemoryBroker, ModelRouter

    cfg = ZooConfig(serving_models="resnet=250@120,bert=500",
                    admission=True, fleet_min_replicas=2,
                    fleet_max_replicas=3, fleet_interval=0.5)
    router = ModelRouter.from_config(cfg, InMemoryBroker())
    assert router.models() == ["resnet", "bert"]
    assert (router.admission_enabled, router.min_replicas,
            router.max_replicas, router.interval) == (True, 2, 3, 0.5)
    with pytest.raises(NotImplementedError, match="item 19"):
        ModelRouter(InMemoryBroker(), "m=100", oracle=object())
    with pytest.raises(ValueError, match="at least one ModelSpec"):
        ModelRouter(InMemoryBroker(), [])
