"""The port's serving fleet (``serving/fleet.py``, ``serving/scaler.py``)
against the JAX package's.  The scaler is pure, so both packages' decisions
are held equal on the same fabricated windows; the controller's tests tick
it by hand (no wall-clock ratios) and hold exactly-once by the serve log."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu_torch.serving import (
    ClusterServing,
    ClusterServingHelper,
    FileBroker,
    InMemoryBroker,
    InputQueue,
    OutputQueue,
)
from analytics_zoo_tpu_torch.serving.fleet import (
    FleetController,
    _SyntheticModel,
    varz_doc,
)
from analytics_zoo_tpu_torch.serving.scaler import FleetSignals, SloScaler

PACKAGES = ("analytics_zoo_tpu", "analytics_zoo_tpu_torch")
STREAM = "image_stream"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _windows(seed: int, n: int = 40) -> list:
    """A seeded run of scaler windows: load ramps up, holds, falls idle,
    with a broker-pressure spike and a stalled (served nothing) window."""
    gen = np.random.default_rng(seed)
    out = []
    for i in range(n):
        load = 1.0 if i < 8 else (6.0 if i < 20 else 0.05)
        depth = int(gen.poisson(30 * load)) if i < 26 else 0
        rate = float(gen.uniform(20, 80)) if i != 12 else 0.0
        out.append(dict(
            predict_p99_s=float(gen.gamma(2.0, 0.02 * min(load, 3.0))),
            window_count=int(gen.integers(0, 40)) if i < 26 else 0,
            service_rate=rate if i < 26 else 0.0,
            queue_depth=depth,
            memory_ratio=0.7 if i == 15 else float(gen.uniform(0, 0.1))))
    return out


SCALERS = [
    dict(slo_p99_ms=500.0),
    dict(slo_p99_ms=150.0, min_replicas=1, max_replicas=6, up_windows=1,
         down_windows=3),
    dict(slo_p99_ms=300.0, min_replicas=2, max_replicas=3, up_windows=3,
         down_windows=2, slack_ratio=0.8, memory_high=0.9),
    dict(slo_p99_ms=200.0, max_replicas=8, prior_target=5),
]


def _decisions(pkg, kwargs, seed):
    import importlib

    scaler = importlib.import_module(f"{pkg}.serving.scaler")
    sc = scaler.SloScaler(**kwargs)
    replicas = sc.initial_target()
    out = [replicas]
    for w in _windows(seed):
        sig = scaler.FleetSignals(**w)
        out.append(sc.estimate_p99_s(sig))
        replicas, reason = sc.decide(replicas, sig)
        out.append((replicas, reason))
        out.append(sc.decide_fleet(replicas, 2, sig, max_hosts=3))
    return out


@pytest.mark.parametrize("case", range(len(SCALERS)))
def test_scaler_decisions_match_the_reference(case):
    ref, port = [_decisions(p, SCALERS[case], seed=case) for p in PACKAGES]
    assert port == ref
    reasons = {d[-1] for d in ref if isinstance(d, tuple)}
    assert reasons & {"slo_violation", "stalled_backlog",
                      "broker_pressure"}


def test_scaler_validation_matches_the_reference():
    import importlib

    bad = [dict(slo_p99_ms=0.0), dict(min_replicas=0),
           dict(min_replicas=3, max_replicas=2)]

    def run(pkg):
        scaler = importlib.import_module(f"{pkg}.serving.scaler")
        out = [scaler.DEFAULT_SLO_P99_MS]
        for kw in bad:
            with pytest.raises(ValueError) as e:
                scaler.SloScaler(**kw)
            out.append(str(e.value))
        return out

    ref, port = [run(p) for p in PACKAGES]
    assert port == ref


class _CountingModel:
    """A model that records each predict's batch size and takes
    ``sleep_per_record_s`` a record (GIL-releasing)."""

    def __init__(self, sleep_per_record_s=0.0):
        self.sleep_s = sleep_per_record_s
        self.batches = []
        self._lock = threading.Lock()

    def predict(self, arr):
        with self._lock:
            self.batches.append(int(arr.shape[0]))
        if self.sleep_s:
            time.sleep(self.sleep_s * arr.shape[0])
        out = np.zeros((arr.shape[0], 5), np.float32)
        out[:, 0] = 1.0
        return out


def _collect(outq, want, seconds):
    got = {}
    deadline = time.time() + seconds
    while len(got) < want and time.time() < deadline:
        got.update(outq.dequeue())
        time.sleep(0.01)
    return got


def test_thread_fleet_scales_up_and_down(tmp_path):
    """Ticked by hand: a backlog the one replica cannot drain is a
    violation two windows running (scale up), an idle fleet six windows
    of slack (scale down, one replica a decision); every record served
    exactly once by the serve log."""
    from analytics_zoo_tpu_torch.metrics import get_flight_recorder

    broker = InMemoryBroker()
    log = str(tmp_path / "served.log")
    helper = ClusterServingHelper(
        model_path=None, batch_size=8, batch_budget_ms=5, lease_ms=5000,
        log_dir=str(tmp_path))
    models = []

    def factory():
        models.append(_CountingModel(0.004))
        return models[-1]

    ctrl = FleetController(
        helper, broker, model_factory=factory, serve_log=log,
        scaler=SloScaler(slo_p99_ms=100.0, min_replicas=1, max_replicas=3,
                         up_windows=2, down_windows=2),
        interval=3600.0)  # the control thread never ticks by itself
    ctrl.start()
    try:
        inq = InputQueue(broker=broker)
        for i in range(400):
            inq.enqueue(f"u{i}", np.zeros((3,), np.float32))
        ctrl._tick()
        time.sleep(0.2)
        ctrl._tick()
        assert ctrl.replica_count() > 1, ctrl.decision_log()
        got = _collect(OutputQueue(broker=broker), 400, 120)
        assert len(got) == 400
        for _ in range(8):
            ctrl._tick()
            time.sleep(0.01)
        assert ctrl.replica_count() == 1, ctrl.decision_log()
        decisions = ctrl.decision_log()
    finally:
        ctrl.stop()
    acts = [d["action"] for d in decisions]
    assert acts[0] == "up" and "down" in acts
    assert decisions[0]["reason"] in ("slo_violation", "stalled_backlog")
    assert [d["reason"] for d in decisions if d["action"] == "down"] == \
        ["sustained_slack"] * acts.count("down")
    lines = [ln.split() for ln in open(log).read().splitlines()]
    assert sorted(u for _, u in lines) == sorted(f"u{i}" for i in range(400))
    assert len({o for o, _ in lines}) > 1  # the scaled-up replicas served
    assert broker.xlen(STREAM) == 0
    assert sum(sum(m.batches) for m in models) == 400
    doc = varz_doc()
    assert any(c["current"]["slo_p99_ms"] == 100.0
               for c in doc["controllers"])
    kinds = {e.get("kind") for e in get_flight_recorder().events()}
    assert "fleet_scale" in kinds


def test_supervision_replaces_a_dead_replica(tmp_path):
    helper = ClusterServingHelper(
        model_path=None, batch_size=4, batch_budget_ms=5, lease_ms=1000,
        log_dir=str(tmp_path))
    ctrl = FleetController(
        helper, InMemoryBroker(), model_factory=lambda: _SyntheticModel(0.0),
        scaler=SloScaler(slo_p99_ms=1000.0, min_replicas=2,
                         max_replicas=2),
        interval=3600.0)
    ctrl.start()
    try:
        assert ctrl.replica_count() == 2
        with ctrl._lock:
            victim = ctrl._replicas[0]
        victim.server.stop()  # a replica death
        assert ctrl._supervise() == 2
        with ctrl._lock:
            alive = [r for r in ctrl._replicas if r.alive()]
        assert len(alive) == 2 and victim not in alive
        assert [d["action"] for d in ctrl.decision_log()] == ["replace"]
    finally:
        ctrl.stop()
    assert ctrl.replica_count() == 0


def test_reader_failure_requeues_claims_instead_of_wedging(tmp_path):
    """A broker hiccup after a claim must requeue the claimed records
    (the 60 s lease makes the requeue the only way they are re-served
    inside the test)."""

    class HiccupBroker(InMemoryBroker):
        def __init__(self):
            super().__init__()
            self.hiccups = 2

        def pop_takeovers(self, owner):
            if self.hiccups > 0:
                self.hiccups -= 1
                raise ConnectionError("transient broker hiccup")
            return super().pop_takeovers(owner)

    broker = HiccupBroker()
    inq = InputQueue(broker=broker)
    for i in range(8):
        inq.enqueue(f"u{i}", np.zeros((3,), np.float32))
    srv = ClusterServing(
        ClusterServingHelper(model_path=None, batch_size=8,
                             batch_budget_ms=25.0, lease_ms=60_000,
                             log_dir=str(tmp_path / "logs")),
        model=_CountingModel(), broker=broker, owner="r1")
    srv.start()
    try:
        got = _collect(OutputQueue(broker=broker), 8, 30)
    finally:
        srv.stop()
    assert sorted(got) == sorted(f"u{i}" for i in range(8))
    assert broker.hiccups == 0  # the failure path ran


def test_window_falls_back_to_the_backlog_drain_rate(tmp_path):
    broker = InMemoryBroker()
    for i in range(100):
        broker.xadd(STREAM, {"i": str(i)})
    ctrl = FleetController(
        ClusterServingHelper(model_path=None, batch_size=4,
                             log_dir=str(tmp_path)),
        broker, model_factory=_CountingModel, interval=60.0)
    try:
        ctrl._gather_window()  # baseline window
        time.sleep(0.05)
        drained = broker.claim(STREAM, "elsewhere", 60, lease_ms=5000)
        broker.release(STREAM, "elsewhere", [r[0] for r in drained],
                       done=True)
        sig = ctrl._gather_window()
    finally:
        ctrl.stop()
    assert sig.queue_depth == 40
    assert sig.service_rate > 0
    assert ctrl.scaler.estimate_p99_s(sig) != float("inf")


def test_process_fleet_survives_a_kill9_exactly_once(tmp_path, monkeypatch):
    """A replica that claimed a batch is killed with SIGKILL mid-batch;
    a process-mode fleet started after it serves every record exactly
    once once the lease expires (the serve log is the ledger), and its
    replica publishes its /telemetryz URL for scraper discovery."""
    from analytics_zoo_tpu_torch.metrics.scrape import fleet_varz_targets

    spool = str(tmp_path / "spool")
    log = str(tmp_path / "served.log")
    broker = FileBroker(spool)
    inq = InputQueue(broker=broker)
    for i in range(20):
        inq.enqueue(f"u{i}", np.zeros((3,), np.float32))
    env = dict(os.environ, ZOO_SERVING_LOG_DIR=str(tmp_path))
    # the 2 s a record of A's first batch of 4 outlasts the test
    a = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.fleet",
         "--replica", "--broker", "dir:" + spool, "--owner", "A",
         "--batch-size", "4", "--budget-ms", "10", "--lease-ms", "1500",
         "--synthetic-sleep-ms", "2000", "--serve-log", log],
        env=env, cwd=REPO)
    sdir = os.path.join(spool, "stream-" + STREAM)
    deadline = time.time() + 60
    while time.time() < deadline:
        if os.path.isdir(sdir) and any(
                n.startswith(".c-") for n in os.listdir(sdir)):
            break
        time.sleep(0.05)
    else:
        a.kill()
        pytest.fail("replica A never claimed")
    os.kill(a.pid, signal.SIGKILL)
    a.wait()
    assert not os.path.exists(log) or not open(log).read()

    helper = ClusterServingHelper(
        model_path=None, batch_size=4, batch_budget_ms=10, lease_ms=1500,
        log_dir=str(tmp_path))
    ctrl = FleetController(
        helper, "dir:" + spool, mode="process", serve_log=log,
        scaler=SloScaler(min_replicas=1, max_replicas=1),
        interval=3600.0, replica_metrics=True)
    monkeypatch.setenv("ZOO_SERVING_LOG_DIR", str(tmp_path))
    try:
        ctrl.start()
        got = _collect(OutputQueue(broker=broker), 20, 90)
        found = fleet_varz_targets(broker)()
        owners = ctrl.owners()
    finally:
        ctrl.stop()
    assert len(got) == 20
    lines = [ln.split() for ln in open(log).read().splitlines()]
    assert sorted(u for _, u in lines) == sorted(f"u{i}" for i in range(20))
    assert {o for o, _ in lines} == set(owners)  # all by the survivor
    assert broker.xlen(STREAM) == 0
    assert set(found) == set(owners)
    assert all(u.startswith("http://") for u in found.values())


def test_from_config_reads_the_fleet_knobs(tmp_path):
    from analytics_zoo_tpu_torch.common.engine import ZooConfig

    cfg = ZooConfig(slo_p99_ms=250.0, fleet_min_replicas=2,
                    fleet_max_replicas=5, fleet_interval=0.5)
    ctrl = FleetController.from_config(
        cfg, ClusterServingHelper(log_dir=str(tmp_path)), InMemoryBroker())
    assert (ctrl.scaler.slo_p99_ms, ctrl.scaler.min_replicas,
            ctrl.scaler.max_replicas, ctrl.interval) == (250.0, 2, 5, 0.5)
    with pytest.raises(ValueError, match="cross-process broker spec"):
        FleetController(ClusterServingHelper(log_dir=str(tmp_path)),
                        InMemoryBroker(), mode="process")


def test_synthetic_model_matches_the_reference():
    from analytics_zoo_tpu.serving.fleet import _SyntheticModel as Ref

    x = np.zeros((3, 7), np.float32)
    np.testing.assert_array_equal(_SyntheticModel(0.0).predict(x),
                                  Ref(0.0).predict(x))
    assert FleetSignals().__dict__ == __import__(
        "analytics_zoo_tpu.serving.scaler",
        fromlist=["FleetSignals"]).FleetSignals().__dict__
